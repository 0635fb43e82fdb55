"""The port's Feistel permutation (torchrecsys_tpu_torch/utils/permute.py)
against the JAX package's ``random_permutation``.

JAX draws the six round keys from its key; the port takes them as an
input, so both get the same keys and must give the same permutation bit
for bit, at sizes with odd and even bit widths (the odd ones walk cycles
out of a domain up to twice as large as needed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.utils import permute as jperm
from torchrecsys_tpu_torch.utils import permute as tperm


def _jax_keys(key):
    return np.asarray(
        jax.random.randint(key, (6,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    )


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 17, 100, 1000, 4097, 65536, 70001, 300007])
def test_permutation_matches_jax_bit_for_bit(n):
    key = jax.random.PRNGKey(n + 1)
    want = np.asarray(jperm.random_permutation(key, n))
    got = tperm.random_permutation(torch.from_numpy(_jax_keys(key).astype(np.int64)), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(n))


def test_extreme_keys_stay_in_32_bits():
    """Keys near 2^31 and rows near 2^16 per half exercise the wrapping
    add and multiplies: still a permutation, still JAX's (the JAX function
    draws its keys, so compare with its Feistel directly)."""
    n = 1 << 18
    keys = np.array([2**31 - 2, 2**31 - 3, 0, 1, 2**30, 12345], np.int64)
    got = tperm.random_permutation(torch.from_numpy(keys), n).numpy()
    np.testing.assert_array_equal(np.sort(got), np.arange(n))
    v = jperm._feistel(jnp.arange(n, dtype=jnp.uint32), jnp.asarray(keys, jnp.uint32), 9)
    want = np.asarray(v).astype(np.int64)
    np.testing.assert_array_equal(got, want)  # 2^18 domain == n: no walk


def test_round_keys_range_and_seed():
    g = torch.Generator().manual_seed(5)
    k = tperm.round_keys(g)
    assert k.shape == (6,) and k.dtype == torch.int64
    assert bool(((k >= 0) & (k < 2**31 - 1)).all())
    assert torch.equal(k, tperm.round_keys(torch.Generator().manual_seed(5)))

"""Popularity sampling on the port (torchrecsys_tpu_torch/data/sampling.py)
against the JAX package's (torchrecsys_tpu/data/sampling.py).

The host tables must be the JAX package's bit for bit: ``alias_table``'s
prob (f32), alias (i32) and fallback, and ``popularity_cdf``, over
catalogs of 1, 2, 7 and 1000 items, zero counts, tied counts, alpha 0 and
0.75, and an empty split. The device draws cannot share JAX's threefry
bits, so each port sampler is a draw of uniforms and a pure map from them
to ids: the test reproduces JAX's uniforms from the same key splits,
checks that reproduction against JAX's own draw where the map is the
identity, then feeds the uniforms to the port's map and asks for JAX's
ids exactly. The port's own draws are held to the distribution
(count^0.75 within a chi-square bound, zero-count items never, no
negative equal to its positive).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.data import sampling as js
from torchrecsys_tpu_torch.data import sampling as ts


def _counts_case(name):
    r = np.random.default_rng(11)
    if name == "n1":
        return np.zeros(5, np.int64), 1
    if name == "n2":
        return np.asarray([1, 1, 1, 0]), 2
    if name == "n7_zeros":
        return np.asarray([0, 0, 3, 3, 3, 5, 6, 6, 6, 6]), 7  # 1, 2 and 4 never seen
    if name == "n7_ties":
        return np.repeat(np.arange(7), 4), 7  # every count equal
    if name == "n1000":
        return (r.zipf(1.3, 20_000) - 1) % 1000, 1000
    if name == "empty":
        return np.zeros(0, np.int64), 9
    raise KeyError(name)


CASES = ["n1", "n2", "n7_zeros", "n7_ties", "n1000", "empty"]


@pytest.mark.parametrize("alpha", [0.0, 0.75])
@pytest.mark.parametrize("case", CASES)
def test_alias_table_and_cdf_are_jax_bit_for_bit(case, alpha):
    items, n = _counts_case(case)
    jp, ja, jf = js.alias_table(items, n, alpha)
    tp, ta, tf = ts.alias_table(items, n, alpha)
    assert tp.dtype == np.float32 and ta.dtype == np.int32 and tf.dtype == np.int32
    np.testing.assert_array_equal(tp.view(np.int32), np.asarray(jp, np.float32).view(np.int32))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tf, jf)
    jc = js.popularity_cdf(items, n, alpha)
    tc = ts.popularity_cdf(items, n, alpha)
    np.testing.assert_array_equal(tc.view(np.int32), jc.view(np.int32))


def test_alias_table_keeps_zero_count_items_out_and_the_heaviest_first():
    items, n = _counts_case("n7_zeros")  # counts 2, 0, 0, 3, 0, 1, 4
    prob, alias, fb = ts.alias_table(items, n, 0.75)
    assert (prob[[1, 2, 4]] == 0).all()  # never drawn: their slots always take the alias
    assert set(alias[[1, 2, 4]].tolist()) <= {0, 3, 5, 6}
    assert fb.tolist() == [6, 3]


def _jax_alias_uniforms(key, shape, n):
    """``sample_negatives_alias``'s uniforms (data/sampling.py:177-185)."""
    out = []
    for k in jax.random.split(key):
        ks, kc = jax.random.split(k)
        out.append(np.asarray(jax.random.randint(ks, shape, 0, n, dtype=jnp.int32)))
        out.append(np.asarray(jax.random.uniform(kc, shape, dtype=jnp.float32)))
    return out


def _jax_cdf_uniforms(key, shape):
    """``sample_negatives_weighted``'s uniforms (:219-227)."""
    return [np.asarray(jax.random.uniform(k, shape, dtype=jnp.float32)) for k in jax.random.split(key)]


@pytest.mark.parametrize("avoid", [True, False], ids=["avoid", "collide"])
@pytest.mark.parametrize("shape", [(512,), (4, 512)], ids=["B", "KxB"])
def test_alias_map_gives_jax_ids_from_jax_uniforms(shape, avoid):
    items, n = _counts_case("n7_zeros")
    prob, alias, fb = js.alias_table(items, n, 0.75)
    key = jax.random.PRNGKey(17)
    pos = np.random.default_rng(3).integers(0, n, shape[-1]).astype(np.int32)
    u = _jax_alias_uniforms(key, shape, n)
    # the reproduction first: with every slot kept (prob 1, no alias) the
    # JAX draw is its slot uniform itself
    ident = js.sample_negatives_alias(
        key, jnp.broadcast_to(pos, shape), jnp.ones(n, jnp.float32), jnp.arange(n, dtype=jnp.int32),
        jnp.asarray(fb), avoid_collisions=False,
    )
    np.testing.assert_array_equal(np.asarray(ident), u[0])
    want = js.sample_negatives_alias(
        key, jnp.broadcast_to(pos, shape), jnp.asarray(prob), jnp.asarray(alias), jnp.asarray(fb),
        avoid_collisions=avoid,
    )
    packed = ts.pack_alias(torch.from_numpy(prob), torch.from_numpy(alias))
    got = ts.alias_map(torch.from_numpy(pos.astype(np.int64)), packed, torch.from_numpy(fb),
                       tuple(torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x) for x in u),
                       avoid_collisions=avoid)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if avoid:  # on this skewed 7-item table both collision rules fire
        first = np.where(u[1] < prob[u[0]], u[0], alias[u[0]])
        assert (first == pos).sum() > 10
        assert not (got.numpy() == pos).any()


@pytest.mark.parametrize("avoid", [True, False], ids=["avoid", "collide"])
@pytest.mark.parametrize("shape", [(512,), (4, 512)], ids=["B", "KxB"])
def test_cdf_map_gives_jax_ids_from_jax_uniforms(shape, avoid):
    items, n = _counts_case("n7_zeros")
    cdf = js.popularity_cdf(items, n, 0.75)
    key = jax.random.PRNGKey(5)
    pos = np.random.default_rng(4).integers(0, n, shape[-1]).astype(np.int32)
    u = _jax_cdf_uniforms(key, shape)
    plain = js.sample_negatives_weighted(key, jnp.broadcast_to(pos, shape), jnp.asarray(cdf), False)
    np.testing.assert_array_equal(
        np.asarray(plain), np.minimum(np.searchsorted(cdf, u[0], side="right"), n - 1)
    )
    want = js.sample_negatives_weighted(key, jnp.broadcast_to(pos, shape), jnp.asarray(cdf), avoid)
    got = ts.cdf_map(torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(cdf),
                     tuple(torch.from_numpy(x) for x in u), avoid_collisions=avoid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_draws_follow_count_power_alpha():
    """2^20 alias draws and 2^20 inverse-CDF draws on the CPU: chi-square
    against count^0.75 below its 0.999 quantile (df = 999 items with mass:
    1137.7), zero-count items never, no negative equal to its positive."""
    items, n = _counts_case("n1000")
    counts = np.bincount(items, minlength=n)
    prob, alias, fb = ts.alias_table(items, n, 0.75)
    gen = torch.Generator().manual_seed(0)
    m = 1 << 20
    pos = torch.full((m,), n + 5)  # no collision possible: the draw itself
    a = ts.sample_negatives_alias(gen, pos, torch.from_numpy(prob), torch.from_numpy(alias),
                                  torch.from_numpy(fb))
    c = ts.sample_negatives_weighted(gen, pos, torch.from_numpy(ts.popularity_cdf(items, n, 0.75)))
    w = counts.astype(np.float64) ** 0.75
    expect = w / w.sum() * m
    live = counts > 0
    for draws in (a, c):
        got = np.bincount(draws.numpy(), minlength=n)
        assert got[~live].sum() == 0
        chi2 = (((got - expect) ** 2) / np.where(live, expect, 1))[live].sum()
        assert chi2 < 1137.7, chi2
    real = torch.from_numpy(items[: 1 << 14])
    for draws in (
        ts.sample_negatives_alias(gen, real, torch.from_numpy(prob), torch.from_numpy(alias),
                                  torch.from_numpy(fb)),
        ts.sample_negatives_alias(gen, real, torch.from_numpy(prob), torch.from_numpy(alias),
                                  torch.from_numpy(fb), shape=(8, 1 << 14)),
    ):
        assert not bool((draws == real).any())

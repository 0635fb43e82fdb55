"""The port's fused pairwise step (torchrecsys_tpu_torch/ops/fused_pairwise.py)
against the JAX package's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and passed to both packages as
numpy arrays. Random inputs: every output within rtol=1e-5, atol=1e-6
(f32 sums in another order; XLA's CPU rsqrt is an approximation where
torch's is 1/sqrt). bf16 (AMP) inputs: rtol=2e-2, atol=2e-3, the tolerance
the JAX package holds its own AMP paths to (tests/test_fused_pairwise.py:
169-210). Exact-arithmetic inputs (small integers, dyadic weights, power-
of-two scalars and accumulators, so every sum, product and rsqrt is exact
in f32): every output identical, including rows that sit on the hinge's
kink (diff == 0), where half the subgradient goes to each side.

The CUDA kernel itself runs only on a card: the ``gpu`` tests at the end
hold it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.ops import fused_pairwise as jfp
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp

RTOL, ATOL = 1e-5, 1e-6
D = 16


def _rows(b, seed, d=D):
    """Three (b, 128) packed row blocks: normal vectors and biases,
    non-negative accumulators, zero padding."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = np.zeros((b, 128), np.float32)
        x[:, :d] = r.normal(size=(b, d)) * 0.5
        x[:, d] = np.abs(r.normal(size=b))
        x[:, d + 1] = r.normal(size=b) * 0.1
        x[:, d + 2] = np.abs(r.normal(size=b))
        out.append(x)
    return out


def _exact_rows(b, seed, d=D):
    """Small-integer vectors and biases; accumulators in {1, 4, 16}. With
    inv = 2^-14 every mean square stays below half an ulp of its
    accumulator, so each rsqrt argument is a power of four."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = np.zeros((b, 128), np.float32)
        x[:, :d] = r.integers(-2, 3, (b, d))
        x[:, d] = r.choice([1.0, 4.0, 16.0], b)
        x[:, d + 1] = r.integers(-1, 2, b)
        x[:, d + 2] = r.choice([1.0, 4.0, 16.0], b)
        out.append(x)
    return out


def _jax(u, p, n, w, inv, lr, **kw):
    uo, po, no, loss = jfp._pairwise_updates_rows(
        jnp.asarray(u), jnp.asarray(p), jnp.asarray(n),
        None if w is None else jnp.asarray(w), jnp.float32(inv), lr,
        interpret=True, **kw,
    )
    items = None if po is None else np.concatenate([np.asarray(po), np.asarray(no)])
    return np.asarray(uo), items, np.asarray(loss)


def _port(fn, u, p, n, w, inv, lr, **kw):
    uo, items, loss = fn(
        torch.from_numpy(u), torch.from_numpy(p), torch.from_numpy(n),
        None if w is None else torch.from_numpy(w), inv, lr, **kw,
    )
    return uo.numpy(), None if items is None else items.numpy(), loss.numpy()


def _assert_outputs(got, want, rtol=RTOL, atol=ATOL, exact=False):
    for name, g, w in zip(("upd_u", "upd_items", "loss_sum"), got, want):
        if w is None:
            assert g is None, name
        elif exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# (loss, sigmoid, weighted, emit_g, item_upd): every loss with and without
# the sigmoid; weights on and off; the emit_g / item_upd variants spread
# over them
_VARIANTS = [
    ("hinge", False, True, False, True),
    ("hinge", False, False, True, True),
    ("hinge", True, True, True, False),
    ("bpr", False, False, False, True),
    ("bpr", True, True, True, True),
    ("logistic", False, True, True, False),
    ("logistic", True, False, False, True),
]


@pytest.mark.parametrize("loss,sigmoid,weighted,emit_g,item_upd", _VARIANTS)
def test_rows_match_pallas(loss, sigmoid, weighted, emit_g, item_upd):
    b = 64
    u, p, n = _rows(b, seed=len(loss) + 2 * sigmoid + 4 * emit_g)
    w = np.random.default_rng(1).random(b).astype(np.float32) if weighted else None
    inv = float(np.float32(1.0) / np.float32(w.sum())) if weighted else float(np.float32(1 / b))
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=sigmoid, eps=1e-10,
              emit_g=emit_g, item_upd=item_upd)
    want = _jax(u, p, n, w, inv, 0.05, **kw)
    _assert_outputs(_port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw), want)
    # the wrapper on CPU tensors is the plain version, exactly
    _assert_outputs(
        _port(tfp.pairwise_updates_rows_plain, u, p, n, w, inv, 0.05, **kw),
        _port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw),
        exact=True,
    )


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_bf16_rows_match_pallas(loss):
    b = 48
    u, p, n = _rows(b, seed=11)
    w = np.random.default_rng(2).random(b).astype(np.float32)
    inv = float(np.float32(1.0) / np.float32(w.sum()))
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=False, eps=1e-10, bf16=True, emit_g=True)
    _assert_outputs(
        _port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw),
        _jax(u, p, n, w, inv, 0.05, **kw),
        rtol=2e-2, atol=2e-3,
    )


def test_batch_not_multiple_of_8():
    """The TPU wrapper pads B to its tile and weights the filler 0; the
    port needs no padding."""
    b = 37
    u, p, n = _rows(b, seed=5)
    kw = dict(d=D, margin=1.0, loss_kind="bpr", sigmoid=False, eps=1e-10)
    inv = float(np.float32(1 / b))
    _assert_outputs(
        _port(tfp.pairwise_updates_rows, u, p, n, None, inv, 0.05, **kw),
        _jax(u, p, n, None, inv, 0.05, **kw),
    )


def test_exact_inputs_match_pallas_on_the_hinge_kink():
    b = 96
    u, p, n = _exact_rows(b, seed=3)
    # force diff == 0 on a third of the rows: <u, n> + b_n = <u, p> + b_p - 1
    kink = np.arange(0, b, 3)
    n[kink, : D + 3] = p[kink, : D + 3]
    n[kink, D + 1] -= 1.0
    w = np.random.default_rng(4).choice([0.0, 0.5, 1.0], b).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False, eps=0.0, emit_g=True)
    got = _port(tfp.pairwise_updates_rows, u, p, n, w, 2.0**-14, 0.5, **kw)
    _assert_outputs(got, _jax(u, p, n, w, 2.0**-14, 0.5, **kw), exact=True)
    # on the kink the pair's gradient is half the active one
    gp = got[0][kink, D + 4]
    np.testing.assert_array_equal(gp, -0.5 * w[kink] * 2.0**-14)


def test_pack_round_trip_matches_jax():
    r = np.random.default_rng(0)
    vec = r.normal(size=(70, D + 1)).astype(np.float32)
    bias = r.normal(size=(70, 2)).astype(np.float32)
    want = np.asarray(jfp.pack_side(jnp.asarray(vec), jnp.asarray(bias)))
    got = tfp.pack_side(torch.from_numpy(vec), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), want)
    v2, b2 = tfp.unpack_side(got, D)
    np.testing.assert_array_equal(v2.numpy(), vec)
    np.testing.assert_array_equal(b2.numpy(), bias)


def _tables(seed, n_users=30, n_items=25, meta_rows=9):
    r = np.random.default_rng(seed)
    user, item = (np.zeros((k, 128), np.float32) for k in (n_users, n_items))
    for t in (user, item):
        t[:, :D] = r.normal(size=(t.shape[0], D)) * 0.3
        t[:, D] = np.abs(r.normal(size=t.shape[0])) * 0.1
        t[:, D + 1] = r.normal(size=t.shape[0]) * 0.1
    meta = r.normal(size=(meta_rows, D + 1)).astype(np.float32) * 0.3
    meta[:, D] = np.abs(meta[:, D])
    return user, item, meta


@pytest.mark.parametrize("weighted", [False, True])
def test_step_matches_pallas(weighted):
    """fused_pairwise_step: gather -> rows -> index_add_ scatters (with
    duplicate users and items in the batch) and the mean loss."""
    user, item, _ = _tables(0)
    r = np.random.default_rng(1)
    b = 40
    uid, pid, nid = (r.integers(0, k, b) for k in (30, 25, 25))
    w = (np.arange(b) < 33).astype(np.float32) if weighted else None
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False)
    ju, ji, jl = jfp.fused_pairwise_step(
        jnp.asarray(user), jnp.asarray(item), *(jnp.asarray(x, jnp.int32) for x in (uid, pid, nid)),
        None if w is None else jnp.asarray(w), 0.05, interpret=True, **kw,
    )
    tu, ti, tl = tfp.fused_pairwise_step(
        torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
        *(torch.from_numpy(x) for x in (uid, pid, nid)),
        None if w is None else torch.from_numpy(w), 0.05, **kw,
    )
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_meta_step_matches_pallas():
    """fused_pairwise_step_meta (Linear): composite rows, the kernel's
    emitted g lanes, per-feature metadata deltas into the augmented
    (Rf, D+1) table."""
    user, item, meta = _tables(2)
    r = np.random.default_rng(3)
    b = 32
    uid, pid, nid = (r.integers(0, k, b) for k in (30, 25, 25))
    meta_ids = r.integers(0, 9, (25, 1, 3))
    meta_mask = r.random((25, 1, 3)) < 0.7
    w = (np.arange(b) < 29).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind="bpr", sigmoid=False)
    ju, ji, jm, _, jl = jfp.fused_pairwise_step_meta(
        jnp.asarray(user), jnp.asarray(item), (jnp.asarray(meta),), None,
        jnp.asarray(meta_ids, jnp.int32), jnp.asarray(meta_mask),
        *(jnp.asarray(x, jnp.int32) for x in (uid, pid, nid)), jnp.asarray(w), 0.05,
        interpret=True, fm=False, **kw,
    )
    tu, ti, tm, tl = tfp.fused_pairwise_step_meta(
        torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
        [torch.from_numpy(meta.copy())],
        torch.from_numpy(meta_ids), torch.from_numpy(meta_mask),
        *(torch.from_numpy(x) for x in (uid, pid, nid)), torch.from_numpy(w), 0.05, **kw,
    )
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    u, p, n = (torch.from_numpy(x) for x in _rows(8, seed=0))
    kw = dict(margin=1.0, loss_kind="hinge", sigmoid=False, eps=1e-10)
    with pytest.raises(ValueError, match="packed"):
        tfp.pairwise_updates_rows(u[:, :64], p, n, None, 0.1, 0.1, d=D, **kw)
    with pytest.raises(ValueError, match="d=123"):
        tfp.pairwise_updates_rows(u, p, n, None, 0.1, 0.1, d=123, emit_g=True, **kw)
    with pytest.raises(ValueError, match="unsupported loss"):
        tfp.pairwise_updates_rows(u, p, n, None, 0.1, 0.1, d=D, **dict(kw, loss_kind="warp"))


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("emit_g,item_upd", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, loss, sigmoid, weighted, emit_g, item_upd, bf16):
    b = 1000
    u, p, n = (torch.from_numpy(x).to(cuda_device) for x in _rows(b, seed=7, d=80))
    w = torch.rand(b, device=cuda_device) if weighted else None
    kw = dict(d=80, margin=1.0, loss_kind=loss, sigmoid=sigmoid, eps=1e-10,
              emit_g=emit_g, item_upd=item_upd, bf16=bf16)
    before = tfp.pairwise_updates_rows.launches
    got = tfp.pairwise_updates_rows(u, p, n, w, 1e-3, 0.05, **kw)
    want = tfp.pairwise_updates_rows_plain(u, p, n, w, 1e-3, 0.05, **kw)
    torch.cuda.synchronize()
    assert tfp.pairwise_updates_rows.launches == before + 1
    for g, x in zip(got, want):
        if x is None:
            assert g is None
        else:
            torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-6)

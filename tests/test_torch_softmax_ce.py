"""The port's in-batch softmax CE (torchrecsys_tpu_torch/ops/softmax_ce.py)
against the JAX package: its XLA formulation (``_inbatch_softmax_rows``)
and its Pallas kernels #4 and #5 in interpret mode, on the same numpy
inputs.

Tolerance 2e-5 (rtol and atol), as the JAX package holds its kernel to its
XLA formulation (tests/test_softmax.py:296): f32 sums over B columns in
another order, and the LSE taken in one pass here and two there.

The CUDA kernels run only on a card: the ``gpu`` tests at the end hold
them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.ops import softmax_ce as jsce
from torchrecsys_tpu.train.trainer import _inbatch_softmax_rows
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import softmax_ce as sce
from torchrecsys_tpu_torch.train import Trainer

TOL = 2e-5


def _inputs(b, d=16, n=1000, dup_heavy=False, seed=0):
    """h, v (b, d), vb (b,), pos (b,) and logq (n,) as numpy; dup_heavy
    draws the positives from 10 ids."""
    r = np.random.default_rng(seed)
    h = r.normal(size=(b, d)).astype(np.float32)
    v = r.normal(size=(b, d)).astype(np.float32)
    vb = r.normal(size=b).astype(np.float32)
    pos = r.integers(0, 10 if dup_heavy else n, b).astype(np.int32)
    logq = (r.normal(size=n) * 0.1).astype(np.float32)
    return h, v, vb, pos, logq


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    if t.dtype == torch.int32:
        t = t.long()
    return t.requires_grad_() if grad else t


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def _jax_ref(h, v, vb, pos, logq, pallas):
    """JAX per-row CE and the gradients of its mean w.r.t. (h, v, vb)."""
    lq = None if logq is None else jnp.asarray(logq)
    args = tuple(jnp.asarray(x) for x in (h, v, vb))
    p = jnp.asarray(pos)

    def per_row(h_, v_, vb_):
        if pallas:
            vbq = vb_ if lq is None else vb_ - jnp.take(lq, p)
            return jsce.inbatch_softmax_ce(h_, v_, vbq, p, True)
        return _inbatch_softmax_rows(h_, v_, vb_, p, lq)

    grads = jax.grad(lambda *a: jnp.mean(per_row(*a)), argnums=(0, 1, 2))(*args)
    return np.asarray(per_row(*args)), [np.asarray(g) for g in grads]


def _port(h, v, vb, pos, logq, fn):
    th, tv, tvb = _t(h, True), _t(v, True), _t(vb, True)
    tp = _t(pos)
    lq = None if logq is None else _t(logq)
    if fn == "kernel":
        vbq = tvb if lq is None else tvb - lq[tp]
        rows = sce.inbatch_softmax_ce(th, tv, vbq, tp)
    else:
        rows = sce.inbatch_softmax_rows_plain(th, tv, tvb, tp, lq)
    grads = torch.autograd.grad(rows.mean(), [th, tv, tvb])
    return rows.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("logq_on", [True, False], ids=["logq", "no_logq"])
@pytest.mark.parametrize("b,dup", [(128, False), (256, True), (512, False)], ids=["b128", "b256dup", "b512"])
def test_ce_and_grads_match_jax(b, dup, logq_on):
    """Both port routes (the kernels' contract through InBatchSoftmaxCE,
    and the XLA formulation) against both JAX routes (kernels #4 and #5 in
    interpret mode, and the XLA formulation)."""
    h, v, vb, pos, logq = _inputs(b, dup_heavy=dup)
    logq = logq if logq_on else None
    want = {k: _jax_ref(h, v, vb, pos, logq, k) for k in (False, True)}
    for fn in ("kernel", "xla"):
        got_rows, got_grads = _port(h, v, vb, pos, logq, fn)
        for w_rows, w_grads in want.values():
            _close(got_rows, w_rows)
            for g, w in zip(got_grads, w_grads):
                _close(g, w)


@pytest.mark.parametrize("logq_on", [True, False], ids=["logq", "no_logq"])
def test_ragged_batch_matches_xla(logq_on):
    """B = 100 divides no TPU row tile: the JAX kernel does not take it,
    the port's kernel contract does."""
    h, v, vb, pos, logq = _inputs(100, d=24, n=60, seed=4)
    logq = logq if logq_on else None
    assert not jsce.softmax_kernel_applicable(100, 24)
    assert sce.softmax_kernel_applicable(100, 24)
    w_rows, w_grads = _jax_ref(h, v, vb, pos, logq, pallas=False)
    got_rows, got_grads = _port(h, v, vb, pos, logq, "kernel")
    _close(got_rows, w_rows)
    for g, w in zip(got_grads, w_grads):
        _close(g, w)


def test_fwd_and_bwd_contracts_match_pallas_interpret():
    """softmax_ce_fwd_plain -> (loss, lse) and softmax_ce_bwd_plain -> (dh,
    dv, dvb) for a per-row cotangent with zeros (the weighted remainder
    batch) against JAX's _call_fwd and _ce_bwd."""
    h, v, vb, pos, logq = _inputs(256, dup_heavy=True, seed=2)
    vbq = vb - logq[pos]
    g = np.random.default_rng(3).random(256).astype(np.float32)
    g[::7] = 0.0
    jargs = (jnp.asarray(h), jnp.asarray(v), jnp.asarray(vbq), jnp.asarray(pos))
    off = jnp.zeros((), jnp.int32)
    jloss, jlse = jsce._call_fwd(*jargs, jargs[3], off, True)
    jdh, jdv, jdvb, *_ = jsce._ce_bwd(True, (*jargs, jargs[3], off, jlse), jnp.asarray(g))
    targs = (_t(h), _t(v), _t(vbq), _t(pos))
    loss, lse = sce.softmax_ce_fwd(*targs)  # CPU tensors: the plain version
    _close(loss.numpy(), jloss)
    _close(lse.numpy(), np.asarray(jlse)[:, 0])
    dh, dv, dvb = sce.softmax_ce_bwd(*targs, lse, _t(g))
    for got, want in ((dh, jdh), (dv, jdv), (dvb, jdvb)):
        _close(got.numpy(), want)
    assert sce.softmax_ce_fwd.launches == 0 and sce.softmax_ce_bwd.launches == 0


def test_autograd_function_matches_torch_autograd_of_the_formulation():
    """InBatchSoftmaxCE's backward (the kernels' contract) against torch
    autograd through the plain formulation, for a weighted loss."""
    h, v, vb, pos, logq = _inputs(192, d=12, n=30, seed=5)
    w = _t(np.random.default_rng(6).random(192).astype(np.float32))
    th, tv, tvbq = _t(h, True), _t(v, True), _t(vb - logq[pos], True)
    tp = _t(pos)
    out = []
    for fn in (sce.inbatch_softmax_ce, lambda *a: sce.inbatch_softmax_rows_plain(*a, None)):
        rows = fn(th, tv, tvbq, tp)
        out.append([rows.detach()] + list(torch.autograd.grad((rows * w).sum(), [th, tv, tvbq])))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_duplicate_positives_masked_and_diagonal_kept():
    """tests/test_softmax.py:109-122's hand case: all logits equal; rows
    sharing a positive drop each other's column but keep their own."""
    h, v = torch.ones((3, 2)), torch.ones((3, 2))
    pos = torch.tensor([5, 5, 9])
    loss, lse = sce.softmax_ce_fwd(h, v, torch.zeros(3), pos)
    np.testing.assert_allclose(loss.numpy(), np.log([2.0, 2.0, 3.0]), rtol=1e-6)
    np.testing.assert_allclose(lse.numpy(), 2.0 + np.log([2.0, 2.0, 3.0]), rtol=1e-6)
    all_same = torch.tensor([4, 4, 4])  # only the diagonal is left: loss 0
    loss, _ = sce.softmax_ce_fwd(h, v, torch.zeros(3), all_same)
    np.testing.assert_allclose(loss.numpy(), 0.0, atol=1e-7)


def test_kernel_applicability_is_by_shape():
    assert sce.softmax_kernel_applicable(4096, 80)
    assert sce.softmax_kernel_applicable(100, 80)  # ragged B: the kernels mask it
    assert sce.softmax_kernel_applicable(1, 128)
    assert not sce.softmax_kernel_applicable(4096, 129)  # d > 128 lanes
    assert not sce.softmax_kernel_applicable(0, 80)


def test_wide_vectors_take_the_xla_formulation(monkeypatch):
    """n_factors > 128: the trainer's CE is the plain formulation, chosen by
    shape before anything is built or launched (JAX trainer.py:310-318)."""
    r = np.random.default_rng(0)
    data = {"user_id": r.integers(0, 20, 300), "item_id": r.integers(0, 30, 300)}
    store = prepare_data(data, "user_id", "item_id")
    tr = Trainer(build_model(store.schema, ModelConfig(n_factors=130)),
                 TrainConfig(loss="sampled_softmax", batch_size=64), "cpu")

    def refuse(*a, **k):
        raise AssertionError("the CE kernels' path was taken for d > 128")

    monkeypatch.setattr(sce, "inbatch_softmax_ce", refuse)
    h, v, vb, pos, logq = _inputs(64, d=130, n=30, seed=8)
    got = tr._softmax_rows(_t(h), _t(v), _t(vb), _t(pos), _t(logq))
    want = _inbatch_softmax_rows(*(jnp.asarray(x) for x in (h, v, vb, pos, logq)))
    _close(got.numpy(), want)
    state = tr.init_state()
    state, loss = tr.train_epoch(state, tr._device_train_data(store), tr.feature_tables(store))
    assert np.isfinite(float(loss))


def test_wrappers_check_their_inputs():
    h, v, vb, pos, _ = (_t(x) for x in _inputs(8, d=4))
    with pytest.raises(ValueError, match="alike"):
        sce.softmax_ce_fwd(h, v[:, :3], vb, pos)
    with pytest.raises(ValueError, match="per-row"):
        sce.softmax_ce_fwd(h, v, vb[:7], pos)
    with pytest.raises(ValueError, match="per-row"):
        sce.softmax_ce_bwd(h, v, vb, pos, vb, vb[:5])
    with pytest.raises(ValueError, match="empty"):
        sce.softmax_ce_fwd(h[:0], v[:0], vb[:0], pos[:0])


# ---------------------------------------------------------------------------
# the forward kernel's 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------


def _tf32(x):
    """x with its low 13 mantissa bits cleared: the TF32 value the tensor
    cores read from an f32 operand."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_logits(h, v, terms):
    """h . v^T from TF32 parts: x = big + small with big = tf32(x) and
    small = tf32(x - big), as the forward kernel splits both operands. The
    products of the parts are exact here (f64) and the logit rounds to f32,
    as the kernel's f32 accumulators do. ``terms`` names the products kept
    beside big.big: "h_small" (h_small.v_big), "v_small" (h_big.v_small)."""
    hb, vb = _tf32(h), _tf32(v)
    hs, vs = _tf32(h - hb), _tf32(v - vb)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    small = np.zeros((h.shape[0], v.shape[0]))
    if "h_small" in terms:
        small += f(hs) @ f(vb).T
    if "v_small" in terms:
        small += f(hb) @ f(vs).T
    return (small + f(hb) @ f(vb).T).astype(np.float32)


def _main_path_ce_inputs(d, seed):
    """B = 1024 rows at the main path's scale: h, v ~ N(0, 0.5^2), vbq = a
    small item bias minus logQ, logq ~ log(1/1M) + N(0, 0.5^2)."""
    r = np.random.default_rng(seed)
    b, n = 1024, 1_000_000
    h = (r.normal(size=(b, d)) * 0.5).astype(np.float32)
    v = (r.normal(size=(b, d)) * 0.5).astype(np.float32)
    pos = r.integers(0, n, b)
    logq = (r.normal(size=n) * 0.5 - np.log(n)).astype(np.float32)
    vbq = ((r.normal(size=b) * 0.1).astype(np.float32) - logq[pos]).astype(np.float32)
    return h, v, vbq, pos


def _ce_from_logits(s, vbq, pos):
    """(loss, lse) of f32 logits s (B, B) + vbq with duplicates masked: the
    forward's fold, as logsumexp."""
    t = torch.from_numpy(s) + torch.from_numpy(vbq)[None, :]
    dup, _ = sce._dup_mask(torch.from_numpy(pos))
    t = t.masked_fill(dup, -torch.inf)
    lse = torch.logsumexp(t, dim=1)
    return lse - torch.diagonal(t), lse


def _within_forward_tolerance(got, want):
    return all(bool(((g - w).abs() <= 1e-5 + 1e-5 * w.abs()).all()) for g, w in zip(got, want))


@pytest.mark.parametrize("d", [80, 128])
def test_3xtf32_logits_meet_the_forward_tolerance(d):
    """Logits from big.big + big.small + small.big (the forward kernel's
    3xTF32 products) give (loss, lse) within the card check's rtol = atol =
    1e-5 of softmax_ce_fwd_plain, at the main path's scale and logQ shift."""
    h, v, vbq, pos = _main_path_ce_inputs(d, seed=d)
    want = sce.softmax_ce_fwd_plain(_t(h), _t(v), _t(vbq), _t(pos))
    got = _ce_from_logits(_split_logits(h, v, ("h_small", "v_small")), vbq, pos)
    assert _within_forward_tolerance(got, want)


@pytest.mark.parametrize("terms", [("h_small",), ("v_small",), ()], ids=["no_v_small", "no_h_small", "1xtf32"])
@pytest.mark.parametrize("d", [80, 128])
def test_fewer_tf32_terms_miss_the_forward_tolerance(d, terms):
    """The same check catches a dropped remainder: with one operand's small
    part left out, or both (plain TF32), (loss, lse) leave the tolerance."""
    h, v, vbq, pos = _main_path_ce_inputs(d, seed=d)
    want = sce.softmax_ce_fwd_plain(_t(h), _t(v), _t(vbq), _t(pos))
    got = _ce_from_logits(_split_logits(h, v, terms), vbq, pos)
    assert not _within_forward_tolerance(got, want)


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,dup", [(4096, 80, False), (4096, 80, True), (1000, 80, False),
                                     (513, 16, False), (300, 128, True), (1000, 13, False),
                                     (7, 80, True), (4096, 84, False), (4097, 80, False)])
def test_kernels_match_plain_on_card(cuda_device, b, d, dup):
    """loss and lse within rtol=atol=1e-5 (f32 sums in another order, a
    one-pass LSE); dh, dv, dvb within rtol 1e-4 and atol 1e-5 of the
    largest reference entry (sums of B terms of both signs). The forward
    and the backward are deterministic: a second run gives the same bits.
    D = 84 has 16-byte rows that are not a multiple of 8 floats; B = 4097
    is one row past a tile."""
    h, v, vb, pos, logq = _inputs(b, d=d, n=5000, dup_heavy=dup, seed=b + d)
    args = [torch.from_numpy(x).to(cuda_device) for x in (h, v, vb - logq[pos])]
    args.append(torch.from_numpy(pos.astype(np.int64)).to(cuda_device))
    g = torch.rand(b, device=cuda_device)
    g[::5] = 0.0
    f0, b0 = sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches
    loss, lse = sce.softmax_ce_fwd(*args)
    loss2, lse2 = sce.softmax_ce_fwd(*args)
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    ploss, plse = sce.softmax_ce_fwd_plain(*args)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    got = sce.softmax_ce_bwd(*args, plse, g)
    again = sce.softmax_ce_bwd(*args, plse, g)
    want = sce.softmax_ce_bwd_plain(*args, plse, g)
    for x, y, z in zip(got, again, want):
        torch.testing.assert_close(x, z, rtol=1e-4, atol=1e-5 * float(z.abs().max()))
        assert torch.equal(x, y)
    assert (sce.softmax_ce_fwd.launches - f0, sce.softmax_ce_bwd.launches - b0) == (2, 2)


@pytest.mark.gpu
def test_forward_with_spread_logits_matches_plain_on_card(cuda_device):
    """h and v at 8x the main path's scale (0.5 -> 4): logits of hundreds,
    so most exponentials underflow and a row's running max moves often.
    loss and lse within rtol=atol=1e-5 of the plain version, bit-identical
    across two runs. The backward is not held here: at such logits an f32
    logit's own rounding moves a probability by more than its check allows,
    in any f32 implementation."""
    h, v, vb, pos, logq = _inputs(4096, d=80, n=5000, seed=21)
    args = [torch.from_numpy(x).to(cuda_device) for x in (h * np.float32(4), v * np.float32(4), vb - logq[pos])]
    args.append(torch.from_numpy(pos.astype(np.int64)).to(cuda_device))
    loss, lse = sce.softmax_ce_fwd(*args)
    loss2, lse2 = sce.softmax_ce_fwd(*args)
    ploss, plse = sce.softmax_ce_fwd_plain(*args)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)

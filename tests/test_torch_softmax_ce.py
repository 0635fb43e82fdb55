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
                                     (7, 80, True)])
def test_kernels_match_plain_on_card(cuda_device, b, d, dup):
    """loss and lse within rtol=atol=1e-5 (f32 sums in another order, a
    one-pass LSE); dh, dv, dvb within rtol 1e-4 and atol 1e-5 of the
    largest reference entry (sums of B terms of both signs). The backward
    is deterministic: a second run gives the same bits."""
    h, v, vb, pos, logq = _inputs(b, d=d, n=5000, dup_heavy=dup, seed=b + d)
    args = [torch.from_numpy(x).to(cuda_device) for x in (h, v, vb - logq[pos])]
    args.append(torch.from_numpy(pos.astype(np.int64)).to(cuda_device))
    g = torch.rand(b, device=cuda_device)
    g[::5] = 0.0
    f0, b0 = sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches
    loss, lse = sce.softmax_ce_fwd(*args)
    ploss, plse = sce.softmax_ce_fwd_plain(*args)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    got = sce.softmax_ce_bwd(*args, plse, g)
    again = sce.softmax_ce_bwd(*args, plse, g)
    want = sce.softmax_ce_bwd_plain(*args, plse, g)
    for x, y, z in zip(got, again, want):
        torch.testing.assert_close(x, z, rtol=1e-4, atol=1e-5 * float(z.abs().max()))
        assert torch.equal(x, y)
    assert (sce.softmax_ce_fwd.launches - f0, sce.softmax_ce_bwd.launches - b0) == (1, 2)

"""The port's fused MLP tower layer (torchrecsys_tpu_torch/ops/fused_tower.py,
kernels #6 and #7) and the MLP's training tower against the JAX package.

On the CPU the wrappers take their plain versions; the same numpy inputs,
made from a seed, go through them and through the JAX kernels in Pallas
interpret mode (``_fwd_call`` / ``_bwd_call``, ``interpret=True``). The
port rounds to bf16 where the TPU kernel does; JAX's interpret mode runs
the kernel body through XLA on the CPU, which keeps some bf16 intermediates
(the z summed into the statistics, xhat and y in the BN sums) in f32.
Hence the tolerances:

- z, din: within one bf16 ulp (2^-7 of the value; in practice identical)
  plus the f32 order error of the product (2^-16 of its absolute terms);
- s, ss, dW, db and the four BN sums: within 2^-7 of the sum of the
  absolute terms (each term differs by at most half a bf16 ulp of up to
  three bf16 factors, plus f32 order).

The MLP's training forward (the fused path) is held to JAX's
``pallas_tower=True`` and ``False`` at the tolerances of
tests/test_fused_tower.py:65-80, its gradients by that file's noise-floor
rule (:83-119), and a row count the TPU kernel cannot take to JAX's XLA
tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import DataSchema as JDataSchema
from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.ops import fused_tower as jft
from torchrecsys_tpu_torch.config import DataSchema, ModelConfig
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import fused_tower as ft
from torchrecsys_tpu_torch.train.losses import hinge_per_row
from torchrecsys_tpu_torch.train.optim import tree_leaves, tree_unflatten
from torchrecsys_tpu_torch.utils.convert import dense_from_jax, model_state_from_jax

BF = torch.bfloat16


def _bf(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t(a) -> torch.Tensor:
    """numpy (bf16 or f32) -> torch, the same bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF)
    return torch.from_numpy(a.copy())


def _f(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)).astype(np.float64)


def _layer_inputs(r, din, dout, seed):
    g = np.random.default_rng(seed)
    x = _bf(g.normal(size=(r, din)))
    w = _bf(g.uniform(-1, 1, size=(din, dout)) / np.sqrt(din))
    b = _bf(g.uniform(-0.1, 0.1, size=dout))
    bn = _bf(np.stack([
        g.normal(size=din) * 0.3, g.uniform(0.5, 1.5, size=din),
        1 + 0.1 * g.normal(size=din), 0.1 * g.normal(size=din),
    ]))
    dz = _bf(g.normal(size=(r, dout)) * 1e-2)
    dstat = (g.normal(size=(2, dout)) * 1e-3).astype(np.float32)
    return x, w, b, bn, dz, dstat


def _within_ulp(got, want, prod):
    """One bf16 ulp of the value, plus the f32 order error of a product
    whose terms' absolute values sum to ``prod`` (a value that cancels to
    near 0 may round differently)."""
    got, want = _f(got), _f(want)
    np.testing.assert_array_less(np.abs(got - want), 2.0**-7 * np.abs(want) + 2.0**-16 * prod + 1e-30)


def _within_sum(got, want, abs_terms, what):
    got, want = _f(got), _f(want)
    bad = np.abs(got - want) > 2.0**-7 * abs_terms + 1e-12
    assert not bad.any(), (what, np.abs(got - want).max(), abs_terms.max())


@pytest.mark.parametrize("has_bn", [False, True], ids=["first", "bn"])
@pytest.mark.parametrize("din,dout", [(16, 64), (64, 32)])
@pytest.mark.parametrize("r", [512, 1024])
def test_plain_layer_matches_jax_interpret(r, din, dout, has_bn):
    x, w, b, bn, dz, dstat = _layer_inputs(r, din, dout, seed=r + din)
    jz, js, jss = jft._fwd_call(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(bn),
                                has_bn=has_bn, interpret=True)
    z, s, ss = ft.fused_tower_fwd(_t(x), _t(w), _t(b), _t(bn), has_bn)
    assert z.dtype == BF and z.shape == (r, dout) and s.dtype == torch.float32
    hb, xhat = ft.bn_relu(_t(x), _t(bn)) if has_bn else (_t(x), None)
    h = _f(hb)
    wa = np.abs(_f(_t(w)))
    _within_ulp(z, jz, np.abs(h) @ wa)
    zf = _f(z)
    _within_sum(s, js, np.abs(zf).sum(0), "s")
    _within_sum(ss, jss, (zf * zf).sum(0), "ss")

    jout = jft._bwd_call(jnp.asarray(x), jnp.asarray(_bf(zf)), jnp.asarray(dz), jnp.asarray(w),
                         jnp.asarray(bn), jnp.asarray(dstat[0]), jnp.asarray(dstat[1]),
                         has_bn=has_bn, interpret=True)
    din_g, dw, db, dbn = ft.fused_tower_bwd(_t(x), z, _t(dz), _t(w), _t(bn), _t(dstat), has_bn)
    # the sums of absolute terms, in f64 from the plain side's quantities
    dzp = _f((_t(dz).float() + _t(dstat)[0] + 2.0 * z.float() * _t(dstat)[1]).to(BF))
    dh = np.abs(dzp) @ wa.T  # bounds |dh| and |dy|
    bnf = _f(_t(bn))
    _within_ulp(din_g, jout[0], dh * (np.abs(bnf[2] * bnf[1]) if has_bn else 1.0))
    _within_sum(dw, jout[1], np.abs(h).T @ np.abs(dzp), "dw")
    _within_sum(db, np.asarray(jout[2])[0], np.abs(dzp).sum(0), "db")
    if not has_bn:
        assert not dbn.any()
        return
    xf = _f(_t(x))
    terms = [dh * np.abs(_f(xhat)), dh, dh * np.abs(bnf[2] * bnf[1]),
             dh * np.abs(bnf[2] * (xf - bnf[0]))]
    for i, (name, t) in enumerate(zip(("dscale", "dbias", "dmean", "dinv"), terms)):
        _within_sum(dbn[i], np.asarray(jout[3])[i], t.sum(0), name)


def _rt(v):
    """bf16 rounding in the forward, the identity in the backward."""
    return v + (v.to(BF).float() - v).detach()


def _unfused_layer(x, w, b, bnvec):
    """The layer in f32 torch autograd on the same bf16-valued inputs, the
    forward rounded where the kernel rounds (so the ReLU masks agree):
    relu(bn(x)) @ w + b and its column sums, nothing fused."""
    m, inv, scale, bias = bnvec
    xhat = _rt(_rt(x - m) * inv)
    h = torch.relu(_rt(_rt(xhat * scale) + bias))
    z = _rt(_rt(h @ w) + b)
    return z, z.sum(0), _rt(z * z).sum(0)


def test_fused_layer_gradients_and_bnvec_order_match_autograd():
    """FusedLayer's backward (the plain kernels' contract) against torch
    autograd of the unfused layer, every input including the four bnvec
    rows one by one: a wrong (mean, inv, scale, bias) order would differ by
    O(1). Tolerance: 1% relative Frobenius distance, the backward's bf16
    rounding of dz', dh and din (2^-9 each) against f32."""
    x, w, b, bn, dz, dstat = _layer_inputs(384, 48, 40, seed=7)
    g = np.random.default_rng(8)
    cz = torch.from_numpy(g.normal(size=(384, 40)).astype(np.float32) * 1e-2)
    cs = torch.from_numpy(g.normal(size=40).astype(np.float32) * 1e-3)
    css = torch.from_numpy(g.normal(size=40).astype(np.float32) * 1e-3)

    def grads(fn, cast):
        ins = [cast(_t(a)).requires_grad_() for a in (x, w, b, bn)]
        z, s, ss = fn(*ins)
        loss = (z.float() * cz).sum() + (s * cs).sum() + (ss * css).sum()
        return torch.autograd.grad(loss, ins)

    got = grads(lambda *a: ft.fused_layer(*a, True), lambda t: t)
    want = grads(_unfused_layer, lambda t: t.float())
    names = ["x", "w", "b", "bn.mean", "bn.inv", "bn.scale", "bn.bias"]
    got = list(got[:3]) + list(got[3])
    want = list(want[:3]) + list(want[3])
    for name, a, c in zip(names, got, want):
        a, c = a.float(), c.float()
        dist = float(torch.linalg.norm(a - c) / torch.linalg.norm(c))
        assert dist < 0.01, (name, dist)


def _mlp_pair(compute="bfloat16", pallas_tower=False, hidden=(64, 32), n_factors=8):
    jm = jbuild(JDataSchema(num_users=40, num_items=30), JModelConfig(
        net_type="mlp", n_factors=n_factors, hidden_layers=hidden, use_batch_norm=True,
        compute_dtype=compute, pallas_tower=pallas_tower))
    tm = build_model(DataSchema(num_users=40, num_items=30), ModelConfig(
        net_type="mlp", n_factors=n_factors, hidden_layers=hidden, use_batch_norm=True,
        compute_dtype=compute))
    return jm, tm


def _mlp_inputs(jm, tm, n):
    params, state = jm.init(jax.random.PRNGKey(0))
    dense_np = jax.tree.map(np.asarray, params["dense"])
    state_np = jax.tree.map(np.asarray, state)
    g = np.random.default_rng(1)
    d = tm.cfg.n_factors
    rows_np = {k: g.normal(size=(n, d)).astype(np.float32) for k in ("user", "item")}
    batch_np = {"user_id": np.zeros(n, np.int32), "item_id": np.zeros(n, np.int32)}
    return params, state, (dense_np, state_np, rows_np, batch_np)


def _port_args(tm, dense_np, state_np, rows_np, batch_np):
    return (dense_from_jax(dense_np, tm, "cpu"), model_state_from_jax(state_np, tm, "cpu"),
            {k: torch.from_numpy(v) for k, v in rows_np.items()},
            {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch_np.items()})


@pytest.mark.parametrize("pallas_tower", [True, False], ids=["jax_kernels", "jax_xla"])
def test_mlp_train_forward_matches_jax(pallas_tower):
    jm, tm = _mlp_pair(pallas_tower=pallas_tower)
    params, state, np_args = _mlp_inputs(jm, tm, 512)
    dense_np, state_np, rows_np, batch_np = np_args
    js, jst = jm.score_rows(params["dense"], state, {k: jnp.asarray(v) for k, v in rows_np.items()},
                            {k: jnp.asarray(v) for k, v in batch_np.items()}, train=True)
    before = ft.fused_tower_fwd.launches
    ts, tst = tm.score_rows(*_port_args(tm, *np_args), train=True)
    assert ft.fused_tower_fwd.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=0, atol=5e-2)
    for a, c in zip(tst["bn"], jst["bn"]):
        np.testing.assert_allclose(a["mean"].detach().numpy(), np.asarray(c["mean"]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a["var"].detach().numpy(), np.asarray(c["var"]), rtol=2e-2, atol=2e-3)


def test_ragged_rows_match_jax_xla_tower():
    """The port's fused path takes any row count; JAX takes its XLA tower
    for a count that is not a multiple of its tile (ROADMAP §C)."""
    jm, tm = _mlp_pair(pallas_tower=True)
    assert not jft.tower_applicable(jm.cfg, 300) and ft.tower_applicable(tm.cfg)
    params, state, np_args = _mlp_inputs(jm, tm, 300)
    dense_np, state_np, rows_np, batch_np = np_args
    js, jst = jm.score_rows(params["dense"], state, {k: jnp.asarray(v) for k, v in rows_np.items()},
                            {k: jnp.asarray(v) for k, v in batch_np.items()}, train=True)
    ts, tst = tm.score_rows(*_port_args(tm, *np_args), train=True)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=0, atol=5e-2)
    for a, c in zip(tst["bn"], jst["bn"]):
        np.testing.assert_allclose(a["mean"].detach().numpy(), np.asarray(c["mean"]), rtol=0, atol=2e-3)
        np.testing.assert_allclose(a["var"].detach().numpy(), np.asarray(c["var"]), rtol=2e-2, atol=2e-3)


def test_mlp_gradients_within_the_bf16_noise_floor():
    """Port gradients (fused path, bf16) against JAX's XLA bf16 tower, judged
    against the distance between JAX's bf16 and f32 towers
    (tests/test_fused_tower.py:83-119): dist < max(1.5 * floor, 0.02)."""
    jm, tm = _mlp_pair()
    jm32 = jbuild(jm.schema, dataclasses.replace(jm.cfg, compute_dtype="float32"))
    params, state, np_args = _mlp_inputs(jm, tm, 512)
    dense_np, state_np, rows_np, batch_np = np_args
    rows = {k: jnp.asarray(v) for k, v in rows_np.items()}
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    b = 256

    def jgrad(model):
        def loss(rows_, dense_):
            s, _ = model.score_rows(dense_, state, rows_, batch, train=True)
            return jnp.mean(jnp.maximum(s[b:] - s[:b] + 1.0, 0.0))

        return jax.grad(loss, argnums=(0, 1))(rows, params["dense"])

    g_x, g_f = jgrad(jm), jgrad(jm32)
    dense, mstate, trows, tbatch = _port_args(tm, *np_args)
    row_leaves = [trows["item"].requires_grad_(), trows["user"].requires_grad_()]
    dl = [p.requires_grad_() for p in tree_leaves(dense)]
    s, _ = tm.score_rows(tree_unflatten(dense, dl), mstate, trows, tbatch, train=True)
    loss = hinge_per_row(s[:b], s[b:], 1.0).mean()
    tg = torch.autograd.grad(loss, row_leaves + dl)
    # JAX's leaves in the same (sorted-key) order
    jx = [g_x[0]["item"], g_x[0]["user"]] + jax.tree_util.tree_leaves(g_x[1])
    jf = [g_f[0]["item"], g_f[0]["user"]] + jax.tree_util.tree_leaves(g_f[1])
    assert len(jx) == len(tg)
    for a, c, f in zip(tg, jx, jf):
        a, c, f = a.float().numpy(), np.asarray(c, np.float32), np.asarray(f, np.float32)
        assert a.shape == c.shape
        dist = np.linalg.norm(a - c) / max(np.linalg.norm(c), 1e-6)
        floor = np.linalg.norm(c - f) / max(np.linalg.norm(f), 1e-6)
        assert dist < max(1.5 * floor, 0.02), (a.shape, dist, floor)


def test_tower_gate():
    _, tm = _mlp_pair()
    assert ft.tower_applicable(tm.cfg)
    assert not ft.tower_applicable(dataclasses.replace(tm.cfg, use_batch_norm=False))
    assert not ft.tower_applicable(dataclasses.replace(tm.cfg, hidden_layers=()))


def test_wrapper_checks():
    x, w, b, bn, dz, dstat = (_t(a) for a in _layer_inputs(16, 8, 4, seed=0))
    with pytest.raises(ValueError, match="bf16"):
        ft.fused_tower_fwd(x.float(), w, b, bn, False)
    with pytest.raises(ValueError, match="bn must be"):
        ft.fused_tower_fwd(x, w, b, bn[:, :4], True)
    with pytest.raises(ValueError, match="dstat"):
        ft.fused_tower_bwd(x, dz, dz, w, bn, dstat[:, :2], True)


@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["unit", "wide"])
def test_bn_chain_in_single_rounding_bf16_ops_matches_plain(scale):
    """The forward kernel forms h = relu(bn(x)), z = bf16(acc) + b and
    bf16(z * z) in bf16x2 arithmetic: each op rounds its exact result to
    bf16 once. The plain version rounds an f32 op on bf16 operands. The
    two agree bit for bit: the f32 op is exact, or its rounding cannot
    reach a bf16 tie. Exact results here come from f64."""
    g = torch.Generator().manual_seed(int(scale))
    n, bf = 1_000_000, torch.bfloat16
    x = (torch.randn(n, generator=g) * scale).to(bf)
    bn = torch.stack([torch.randn(n, generator=g) * 0.3 * scale, torch.rand(n, generator=g) + 0.5,
                      1 + 0.1 * torch.randn(n, generator=g), 0.1 * torch.randn(n, generator=g)]).to(bf)
    f64 = lambda t: t.double()  # noqa: E731
    xhat = (f64((f64(x) - f64(bn[0])).to(bf)) * f64(bn[1])).to(bf)
    h = torch.relu((f64((f64(xhat) * f64(bn[2])).to(bf)) + f64(bn[3])).to(bf))
    assert torch.equal(h.view(torch.int16), ft.bn_relu(x, bn)[0].view(torch.int16))
    acc = torch.randn(n, generator=g) * 5 * scale
    b = bn[3]
    z = (f64(acc.to(bf)) + f64(b)).to(bf)
    assert torch.equal(z.view(torch.int16), (acc.to(bf) + b).view(torch.int16))
    assert torch.equal((f64(z) * f64(z)).to(bf).view(torch.int16), (z * z).view(torch.int16))


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("r,din,dout,has_bn", [(16384, 160, 1024, False), (16384, 1024, 128, True),
                                               (1000, 240, 1024, False), (37, 20, 13, True),
                                               (1000, 100, 60, True), (40, 1024, 128, False),
                                               (16384, 160, 1000, False), (16383, 1024, 128, True)])
def test_kernels_match_plain_on_card(cuda_device, r, din, dout, has_bn):
    """Kernel against plain version on the card: z within one bf16 ulp of
    the product (f32 sums in another order), sums within 2^-7 of their
    absolute terms; a second run gives the same bits."""
    x, w, b, bn, dz, dstat = (_t(a).to(cuda_device) for a in _layer_inputs(r, din, dout, seed=3))
    z, s, ss = ft.fused_tower_fwd(x, w, b, bn, has_bn)
    pz, ps, pss = ft.fused_tower_fwd_plain(x, w, b, bn, has_bn)
    h = ft.bn_relu(x, bn)[0] if has_bn else x
    prod = h.float().abs() @ w.float().abs()
    assert bool(((z.float() - pz.float()).abs() <= 2.0**-7 * (prod + pz.float().abs())).all())
    zf = pz.float()
    assert bool(((s - ps).abs() <= 2.0**-7 * zf.abs().sum(0)).all())
    assert bool(((ss - pss).abs() <= 2.0**-7 * (zf * zf).sum(0)).all())
    out = ft.fused_tower_bwd(x, pz, dz, w, bn, dstat, has_bn)
    again = ft.fused_tower_bwd(x, pz, dz, w, bn, dstat, has_bn)
    want = ft.fused_tower_bwd_plain(x, pz, dz, w, bn, dstat, has_bn)
    for a, c, p in zip(out, again, want):
        assert torch.equal(a, c)
        assert float((a.float() - p.float()).abs().max()) <= 2.0**-7 * float(p.float().abs().max()) + 1e-12

"""AMP training on the port (``use_amp=True``: bf16 compute, f32 tables and
accumulators) against the JAX package's AMP paths.

Pairwise: the fused step's bf16 variant (on the CPU its plain version)
for Linear and FM, with and without metadata, against the JAX Trainer's
AMP epochs at ``pallas_step=True`` (kernel #3's bf16 variant in interpret
mode) and ``False`` (the bf16 XLA step). Sampled softmax: bf16 vectors
from ``pair_vectors`` into the f32 CE (kernels #4/#5 on the card, their
plain versions here), bf16 gradients back.

bf16 rounds at other places in the two packages, so parity is held as the
JAX package holds its own AMP paths (tests/test_fused_pairwise.py:152-210):
epoch losses within rtol=2e-2, atol=2e-3; tables through ``_mostly_close``
(rtol=5e-2, atol=5e-3 on at least 98% of the elements: a hinge pair near
its kink can flip between the paths' roundings, and FM's sigmoid chain
compounds per-step drift on frequently touched rows). The CE's per-row
loss and gradients within 2e-2 (tests/test_softmax.py:406-431).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.ops.softmax_ce import inbatch_softmax_ce as jce
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp
from torchrecsys_tpu_torch.ops import softmax_ce as tsce
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests.test_torch_train import _data, _round_keys, _state_np

D = 16


def _mostly_close(a, b, rtol, atol, frac=0.98, msg=""):
    """allclose on at least ``frac`` of the elements (JAX
    tests/test_fused_pairwise.py:152-164)."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    assert ok.mean() >= frac, (
        f"{msg}: {(~ok).sum()}/{ok.size} elements beyond rtol={rtol}/atol={atol} "
        f"(allowed {(1 - frac) * 100:.1f}%)"
    )


def _trainers(net, meta, loss, jcfg, sigmoid=True):
    data = _data(meta)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = dict(net_type=net, n_factors=D, compute_dtype="bfloat16", fm_sigmoid=sigmoid)
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(
        batch_size=128, learning_rate=0.05, loss=loss, seed=3, **jcfg))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)),
                 TrainConfig(batch_size=128, learning_rate=0.05, loss=loss, seed=3), "cpu")
    assert tt.model.compute_dtype == torch.bfloat16
    return jstore, tstore, jt, tt


def _train_and_compare(jstore, tstore, jt, tt, epochs=2):
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    for _ in range(epochs):
        keys = _round_keys(jstate["rng"])
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2, atol=2e-3)
    assert tstate["step"] == int(jstate["step"])
    assert set(tstate["tables"]) == set(jstate["tables"])
    for name in jstate["tables"]:
        _mostly_close(tstate["tables"][name].numpy(), jstate["tables"][name], rtol=5e-2, atol=5e-3,
                      msg=f"table {name}")
        _mostly_close(tstate["emb_opt"][name]["acc"].numpy(), jstate["emb_opt"][name]["acc"],
                      rtol=5e-2, atol=5e-3, msg=f"acc {name}")
    return tstate


@pytest.mark.parametrize("pallas_step", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("net,meta", [("linear", False), ("fm", False), ("linear", True), ("fm", True)],
                         ids=["linear", "fm", "linear-meta", "fm-meta"])
def test_amp_epochs_match_jax(net, meta, pallas_step):
    """Two AMP hinge epochs from the JAX init with the JAX round keys and
    static negatives: the port's fused step (bf16 variant) against JAX's
    kernel route and its bf16 XLA step."""
    jstore, tstore, jt, tt = _trainers(net, meta, "hinge", dict(pallas_step=pallas_step))
    assert jt._pallas_pairwise() == pallas_step and tt._fused
    _train_and_compare(jstore, tstore, jt, tt)


def test_run_steps_passes_bf16_to_the_step(monkeypatch):
    """run_steps hands bf16=True to every step call under AMP (and, for
    FM with metadata, its linear-metadata tables and fm=True)."""
    store = prepare_data(_data(True), "user_id", "item_id", metadata_id_col=["cat"])
    seen = []
    real = tfp.fused_pairwise_step_meta

    def spy(*a, **k):
        seen.append((k["bf16"], k.get("fm", False), len(k.get("meta_lin") or ())))
        return real(*a, **k)

    monkeypatch.setattr(tfp, "fused_pairwise_step_meta", spy)
    for net, amp in (("linear", True), ("fm", True), ("fm", False)):
        tr = Trainer(build_model(store.schema, ModelConfig(net_type=net, n_factors=8,
                                                           compute_dtype="bfloat16" if amp else "float32")),
                     TrainConfig(batch_size=128), "cpu")
        seen.clear()
        tr.train_epoch(tr.init_state(), tr._device_train_data(store), tr.feature_tables(store),
                       keys=torch.arange(6))
        assert seen and set(seen) == {(amp, net == "fm", 1 if net == "fm" else 0)}, (net, amp, set(seen))


# ---------------------------------------------------------------------------
# sampled softmax under AMP
# ---------------------------------------------------------------------------


def test_amp_ce_rows_and_grads_match_jax():
    """bf16 h, v and an f32 bias through the CE (the plain versions of
    kernels #4/#5 on the CPU) against JAX's kernel in interpret mode: the
    per-row loss and the gradients, which come back in bf16, within 2e-2."""
    b, d = 128, D
    r = np.random.default_rng(0)
    h = r.normal(size=(b, d)).astype(np.float32)
    v = r.normal(size=(b, d)).astype(np.float32)
    vb = r.normal(size=b).astype(np.float32)
    pos = r.integers(0, 50, b)
    jh, jv = jnp.asarray(h, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jpos = jnp.asarray(pos, jnp.int32)
    want = np.asarray(jce(jh, jv, jnp.asarray(vb), jpos, True))
    jgh, jgv = jax.grad(lambda x, y: jnp.mean(jce(x, y, jnp.asarray(vb), jpos, True)), argnums=(0, 1))(jh, jv)
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tv = torch.from_numpy(v).to(torch.bfloat16).requires_grad_()
    got = tsce.inbatch_softmax_ce(th, tv, torch.from_numpy(vb), torch.from_numpy(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    gh, gv = torch.autograd.grad(got.mean(), [th, tv])
    assert gh.dtype == torch.bfloat16 and gv.dtype == torch.bfloat16
    for g, x in ((gh, jgh), (gv, jgv)):
        x = np.asarray(jnp.asarray(x, jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), x, rtol=2e-2, atol=2e-2 * np.abs(x).max())


@pytest.mark.parametrize("net,meta", [("linear", False), ("fm", True)], ids=["linear", "fm-meta"])
def test_amp_softmax_epochs_match_jax(net, meta):
    """Two AMP sampled-softmax epochs (FM with fm_sigmoid=False) against
    JAX's with its CE kernels in interpret mode: the bf16 vectors reach the
    f32 CE, the weighted mean, logQ and the adagrad rows in f32."""
    jstore, tstore, jt, tt = _trainers(net, meta, "sampled_softmax", dict(pallas_softmax=True), sigmoid=False)
    assert tt._softmax and not tt._fused
    _train_and_compare(jstore, tstore, jt, tt)


def test_recsys_amp_fits_every_factorizable_net():
    """RecSys(use_amp=True) fits Linear and FM through the fused step and
    under sampled softmax, evaluates, and predicts from bf16 catalogs."""
    data = _data(True, n=1500, n_users=60, n_items=90)
    for net, loss in (("linear", "hinge"), ("fm", "hinge"), ("linear", "sampled_softmax"),
                      ("fm", "sampled_softmax")):
        rs = RecSys(data, net_type=net, n_factors=8, metadata_id_col=["cat"], use_amp=True,
                    fm_sigmoid=loss != "sampled_softmax", device="cpu")
        losses = rs.fit(epochs=2, batch_size=128, loss=loss, verbose=False)
        assert np.isfinite(losses).all(), (net, loss)
        ev = rs.evaluate(batch_size=64, eval_metrics=("loss", "auc", "recall@5"), verbose=False)
        assert all(np.isfinite(list(ev.values()))), (net, loss, ev)
        q, *_ = rs._linearized()
        assert q.dtype == torch.bfloat16
        assert rs.predict(rs.store.user_encoder.to_list()[:5], top_k=4).shape == (5, 4)


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("net,meta", [("linear", False), ("linear", True), ("fm", False), ("fm", True)])
def test_amp_epochs_on_card_match_cpu(cuda_device, net, meta):
    """The card's AMP epochs (the step kernel's bf16 variant, every call;
    FM with metadata the row-level kernel's) against the CPU's plain bf16
    steps from one start, at the AMP tolerance."""
    data = _data(meta, n=4000, n_users=300, n_items=500)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    store = prepare_data(data, "user_id", "item_id", **kw)
    cfg = TrainConfig(batch_size=256, learning_rate=0.05)
    mcfg = ModelConfig(net_type=net, n_factors=80, compute_dtype="bfloat16")
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, mcfg), cfg, dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: v.clone() for k, v in state["tables"].items()}
        else:
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
        fm_meta = net == "fm" and meta
        step = (tfp.pairwise_updates_rows if fm_meta else tfp.fused_pairwise_step_meta if meta
                else tfp.fused_pairwise_step)
        before = step.launches
        losses = []
        for e in range(2):
            state, loss = tr.train_epoch(state, tr._device_train_data(store), tr.feature_tables(store),
                                         keys=torch.arange(6) + 7 * e)
            losses.append(float(loss))
        if dev != "cpu":
            assert step.launches - before == 2 * -(-store.num_train // 256)
            if fm_meta:  # hinge, sigmoid, weighted, emit_g, no item rows, bf16
                assert step.variant == tfp.row_variant("hinge", True, True, True, False, True)
            else:
                assert step.variant == tfp.step_variant("hinge", net == "fm", True, True, meta)
        out[str(dev)] = (losses, {k: v.cpu() for k, v in state["tables"].items()})
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=2e-2, atol=2e-3)
    for k in tc:
        _mostly_close(tg[k].numpy(), tc[k].numpy(), rtol=5e-2, atol=5e-3, msg=k)

"""The port's MLP slice (models/mlp.py, the autograd pairwise step, the
dense optimizers, the state carry-over, RecSys(net_type="mlp")) against the
JAX package.

Both packages start from the JAX trainer's init, carried over with
``train_state_from_jax`` (tables, accumulators, dense tower, batch-norm
state, optax state), train on the store's static negatives
(``dynamic_neg_sampling=False``: the split and negatives are bit-identical)
and, per epoch, the Feistel round keys the JAX trainer derives. Tolerances:

- f32 compute: tight (rtol=2e-4, atol=1e-6): f32 products summed in
  another order, which adam's first steps (about ``sign(g) * lr``) amplify
  only for gradients near 0;
- bf16 compute: the port's fused tower (the plain versions of kernels #6
  and #7 on the CPU) against JAX's XLA bf16 tower, the rtol=0.08 of the
  JAX package's own fused-against-XLA fit test
  (tests/test_fused_tower.py:122-148) on losses and statistics, and the
  noise-floor rule of that file (:83-119) on each step's parameter change:
  distance to JAX within max(1.5 x the distance between JAX's bf16 and
  f32 steps, 0.02).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.eval.predict import full_catalog_topk as jfull_catalog_topk
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train.optim import make_dense_optimizer
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import fused_tower as ft
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train.optim import (
    apply_dense_update,
    augment_tables,
    init_dense_opt,
    split_augmented,
)
from torchrecsys_tpu_torch.utils.convert import (
    dense_from_jax,
    dense_opt_from_jax,
    model_state_from_jax,
    train_state_from_jax,
)

from tests.test_torch_train import _data, _round_keys

HIDDEN = (32, 16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state_np(js):
    return {k: _np(js[k]) for k in ("tables", "emb_opt", "dense", "model_state", "dense_opt", "step")}


def _mlp_cfg(compute="float32"):
    return dict(net_type="mlp", n_factors=8, hidden_layers=HIDDEN, use_batch_norm=True,
                compute_dtype=compute)


def _pair(data, meta, compute="float32", net="mlp", n_factors=8, jcfg=None, tcfg=None,
          pallas_tower=False):
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = _mlp_cfg(compute) if net == "mlp" else dict(n_factors=n_factors, compute_dtype=compute)
    jmodel = jbuild(jstore.schema, JModelConfig(**mcfg, pallas_tower=pallas_tower))
    jt = JTrainer(jmodel, JTrainConfig(
        batch_size=128, learning_rate=0.05, seed=3, **(jcfg or {})))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)), TrainConfig(
        batch_size=128, learning_rate=0.05, seed=3, **(tcfg or {})), "cpu")
    return jstore, tstore, jt, tt


def _flat(tree):
    """(name, float64 array) leaves of a JAX or port state subtree."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.float32)
        out.append((jax.tree_util.keystr(path), arr.astype(np.float64)))
    return out


def _assert_trees(got, want, rtol, atol, what, skip=()):
    gl, wl = _flat(got), _flat(want)
    assert [n for n, _ in gl] == [n for n, _ in wl], what
    for (name, a), (_, c) in zip(gl, wl):
        if name not in skip:
            np.testing.assert_allclose(a, c, rtol=rtol, atol=atol, err_msg=f"{what}{name}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_f32_eval_scores_match_jax(meta):
    data = _data(meta, n=800)
    jstore, tstore, jt, tt = _pair(data, meta)
    js = jt.init_state(jax.random.PRNGKey(0))
    # running statistics away from (0, 1), so eval normalizes for real
    g = np.random.default_rng(0)
    ms = {"bn": [{"mean": g.normal(size=w).astype(np.float32) * 0.1,
                  "var": g.uniform(0.5, 2.0, size=w).astype(np.float32)} for w in HIDDEN]}
    js = dict(js, model_state=jax.tree.map(jnp.asarray, ms))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu")
    users = np.arange(40) % tstore.schema.num_users
    items = np.arange(40) % tstore.schema.num_items
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    from torchrecsys_tpu.data.features import attach_features as jattach
    from torchrecsys_tpu_torch.data.features import attach_features as tattach

    jside = jattach({"user_id": jnp.asarray(users, jnp.int32), "item_id": jnp.asarray(items, jnp.int32)}, jfeat)
    tside = tattach({"user_id": torch.as_tensor(users), "item_id": torch.as_tensor(items)}, tfeat)
    want, _ = jt.model.score({"tables": js["tables"], "dense": js["dense"]}, js["model_state"], jside)
    got, st = tt.model.score({"tables": ts["tables"], "dense": ts["dense"]}, ts["model_state"], tside)
    assert st is ts["model_state"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["adam", "adamw", "adagrad", "sgd"])
def test_dense_optimizers_match_optax(kind):
    g = np.random.default_rng(1)
    dense = {"layers": [{"w": g.normal(size=(6, 4)), "b": g.normal(size=4)}],
             "out": {"w": g.normal(size=(4, 1)), "b": np.zeros(1)}}
    dense = jax.tree.map(lambda a: np.asarray(a, np.float32), dense)
    tx = make_dense_optimizer(kind, 0.05)
    jp, jo = jax.tree.map(jnp.asarray, dense), tx.init(jax.tree.map(jnp.asarray, dense))
    tp = jax.tree.map(torch.from_numpy, dense)
    to = init_dense_opt(kind, tp)
    # the optax init carries over
    carried = dense_opt_from_jax(_np(jo), kind, tp, "cpu")
    assert set(carried) == set(to)
    for _ in range(3):
        grads = jax.tree.map(lambda a: g.normal(size=a.shape).astype(np.float32), dense)
        upd, jo = tx.update(jax.tree.map(jnp.asarray, grads), jo, jp)
        jp = optax.apply_updates(jp, upd)
        tp, to = apply_dense_update(kind, 0.05, tp, jax.tree.map(torch.from_numpy, grads), to)
    _assert_trees(tp, jp, 1e-6, 1e-7, f"{kind} params")
    back = dense_opt_from_jax(_np(jo), kind, tp, "cpu")
    if kind in ("adam", "adamw"):
        assert to["count"] == back["count"] == 3
    for key in (k for k in to if k != "count"):
        _assert_trees(to[key], back[key], 1e-6, 1e-7, f"{kind} {key}")


def test_state_carry_over_checks_the_layout():
    jstore, tstore, jt, tt = _pair(_data(False), False)
    js = _state_np(jt.init_state(jax.random.PRNGKey(0)))
    ts = train_state_from_jax(js, tt.model, "cpu")
    _assert_trees(ts["dense"], js["dense"], 0, 0, "dense")
    _assert_trees(ts["model_state"], js["model_state"], 0, 0, "model_state")
    assert ts["dense_opt"]["count"] == 0 and ts["step"] == 0
    bad = jax.tree.map(lambda a: a, js["dense"])
    bad["layers"][0]["w"] = bad["layers"][0]["w"][:, :3]
    with pytest.raises(ValueError, match=r"dense\['layers'\]\[0\]\['w'\]"):
        dense_from_jax(bad, tt.model, "cpu")
    with pytest.raises(ValueError, match="model_state"):
        model_state_from_jax({"bn": js["model_state"]["bn"][:1]}, tt.model, "cpu")
    with pytest.raises(ValueError, match="sum_of_squares"):
        dense_opt_from_jax(js["dense_opt"], "adagrad", ts["dense"], "cpu")


# ---------------------------------------------------------------------------
# one step, and fit
# ---------------------------------------------------------------------------


def _one_batch(store, b=48, seed=0):
    """One weighted batch of distinct users (the last 5 rows weigh 0)."""
    g = np.random.default_rng(seed)
    users = g.choice(store.schema.num_users, b, replace=False)
    items = g.choice(store.schema.num_items, 2 * b, replace=False)
    w = (np.arange(b) < b - 5).astype(np.float32)
    return users, items[:b], items[b:], w


def _step_both(meta, compute, optimizer="adam", b=48, **mkw):
    """One step from the same state: JAX's step body on the augmented
    tables (``_step_impl(fused=True)``, what its epoch runs) and the port's
    ``Trainer.pairwise_step``."""
    from torchrecsys_tpu.train.optim import augment_tables as jaugment
    from torchrecsys_tpu.train.optim import split_augmented as jsplit

    data = _data(meta, n=3000, n_users=300, n_items=600)
    opt = dict(dense_optimizer=optimizer)
    jstore, tstore, jt, tt = _pair(data, meta, compute, jcfg=opt, tcfg=opt, **mkw)
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer=optimizer)
    users, pos, neg, w = _one_batch(tstore, b)
    jbatch = {"user_id": jnp.asarray(users, jnp.int32), "pos_item_id": jnp.asarray(pos, jnp.int32),
              "neg_item_id": jnp.asarray(neg, jnp.int32), "_w": jnp.asarray(w)}
    jaug = dict(js, tables=jaugment(js["tables"], js["emb_opt"]))

    def jstep(st, batch, feat):
        return jt._step_impl(st, batch, feat, fused=True)

    js2, jloss = jax.jit(jstep)(jaug, jbatch, jt.feature_tables(jstore))
    tables, emb_opt = jsplit(js2["tables"])
    js2 = dict(js2, tables=tables, emb_opt=emb_opt)
    aug = augment_tables(ts["tables"], ts["emb_opt"])
    tloss = tt.pairwise_step(ts, aug, *(torch.as_tensor(a) for a in (users, pos, neg, w)),
                             float(w.sum()), tt.feature_tables(tstore))
    ts["tables"], ts["emb_opt"] = split_augmented(aug)
    return js, js2, float(jloss), ts, float(tloss)


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_f32_step_matches_jax_train_step(meta, optimizer):
    """Tables, accumulators, batch-norm statistics and the optimizer state
    tight. adam's first step is lr * g / (|g| + 1e-8): where a gradient is 0
    up to rounding (a hidden layer's bias, which batch norm removes; the
    output bias, which cancels in neg - pos; a dead unit) it turns rounding
    into a step of up to lr, so the parameters are held tight only where
    |g| > 1e-5 and mu = 0.1 g holds the gradient itself everywhere."""
    js, js2, jloss, ts, tloss = _step_both(meta, "float32", optimizer)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    rtol, atol = 2e-4, 1e-6
    _assert_trees(ts["tables"], js2["tables"], rtol, atol, "tables")
    _assert_trees(ts["emb_opt"], js2["emb_opt"], rtol, atol, "emb_opt")
    _assert_trees(ts["model_state"], js2["model_state"], rtol, atol, "model_state")
    if optimizer == "adagrad":
        _assert_trees(ts["dense"], js2["dense"], rtol, atol, "dense")
        _assert_trees(ts["dense_opt"]["sum_of_squares"], js2["dense_opt"][0].sum_of_squares,
                      rtol, atol, "sum_of_squares")
        return
    assert ts["dense_opt"]["count"] == 1
    _assert_trees(ts["dense_opt"]["mu"], js2["dense_opt"][0].mu, rtol, 1e-7, "mu")
    _assert_trees(ts["dense_opt"]["nu"], js2["dense_opt"][0].nu, rtol, 1e-12, "nu")
    for (name, a), (_, c), (_, mu) in zip(_flat(ts["dense"]), _flat(js2["dense"]),
                                          _flat(js2["dense_opt"][0].mu)):
        big = np.abs(mu) > 1e-6
        np.testing.assert_allclose(a[big], c[big], rtol=rtol, atol=atol, err_msg=f"dense{name}")
        assert np.all(np.abs(a - c) <= 2 * 0.05 + 1e-6), name


def _deltas(after, before):
    return [(n, a - b) for (n, a), (_, b) in zip(_flat(after), _flat(before))]


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_bf16_step_within_the_noise_floor_of_jax(meta):
    """bf16, 256 pairs (512 rows: one tile of the JAX kernels): the port's
    fused tower against JAX's (``pallas_tower=True``, interpret mode). The
    loss and the batch-norm statistics within rtol=0.08; every parameter
    change within the noise floor of tests/test_fused_tower.py:83-119, the
    distance between JAX's bf16 step and its f32 step from the same state.
    The dense optimizer is sgd, so the dense change is the gradient itself,
    as in that rule; adam's first step is about sign(g) * lr for every
    gradient, tiny ones included."""
    js, js2, jloss, ts, tloss = _step_both(meta, "bfloat16", "sgd", b=256, pallas_tower=True)
    _, jf2, _, _, _ = _step_both(meta, "float32", "sgd", b=256)
    np.testing.assert_allclose(tloss, jloss, rtol=0.08)
    _assert_trees(ts["model_state"], js2["model_state"], 0.08, 1e-3, "model_state")
    for key, port, jax_after, f32_after, before in (
        ("tables", ts["tables"], js2["tables"], jf2["tables"], js["tables"]),
        ("acc", ts["emb_opt"], js2["emb_opt"], jf2["emb_opt"], js["emb_opt"]),
        ("dense", ts["dense"], js2["dense"], jf2["dense"], js["dense"]),
    ):
        for (name, dp), (_, dj), (_, df) in zip(
            _deltas(port, before), _deltas(jax_after, before), _deltas(f32_after, before)
        ):
            dist = np.linalg.norm(dp - dj) / max(np.linalg.norm(dj), 1e-12)
            floor = np.linalg.norm(dj - df) / max(np.linalg.norm(df), 1e-12)
            assert dist < max(1.5 * floor, 0.02), (key, name, dist, floor)


def _fit_both(data, meta, compute, epochs, net="mlp", jcfg=None, **kw):
    jstore, tstore, jt, tt = _pair(data, meta, compute, net=net, jcfg=jcfg, **kw)
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer=tt.cfg.dense_optimizer)
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    losses = []
    for _ in range(epochs):
        keys = _round_keys(js["rng"])
        js, jloss = jt._epoch_jit(js, jdata, jfeat)
        ts, tloss = tt.train_epoch(ts, tdata, tfeat, keys=keys)
        losses.append((float(tloss), float(jloss)))
    return jstore, tstore, jt, tt, js, ts, np.asarray(losses)


def test_amp_recsys_fit_evaluate_predict_track_jax():
    """RecSys(net_type="mlp", use_amp=True) on the CPU: three epochs from
    the carried-over JAX state with JAX's round keys and the static
    negatives, against JAX's Trainer (XLA bf16 tower); then the facade's
    evaluate and predict on the trained state."""
    data = _data(True, n=1500, n_users=60, n_items=50)
    jstore, tstore, jt, tt, js, ts, losses = _fit_both(data, True, "bfloat16", 3)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=0.08)
    assert losses[-1, 0] < losses[0, 0]
    assert tt.model.compute_dtype == torch.bfloat16 and ft.tower_applicable(tt.model.cfg)
    rs = RecSys(data, net_type="mlp", use_amp=True, n_factors=8, hidden_layers=HIDDEN,
                metadata_id_col=["cat"], device="cpu")
    st = _state_np(js)
    rs.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"], model_state=st["model_state"])
    got = rs.evaluate(batch_size=128, eval_metrics=("loss", "auc"), verbose=False)
    want = jt.evaluate(js, jstore, batch_size=128, verbose=False)
    assert abs(got["loss"] - want["loss"]) <= 0.08 * want["loss"]
    assert abs(got["auc"] - want["auc"]) <= 0.05
    users = rs.store.user_encoder.to_list()[:8]
    assert rs.predict(users, top_k=5).shape == (8, 5)


def test_f32_evaluate_and_predict_match_jax():
    """After one JAX epoch (real batch-norm statistics), f32 compute:
    Trainer.evaluate against JAX's on the static test negatives, and
    predict's ids against JAX's full_catalog_topk."""
    data = _data(True, n=1500, n_users=60, n_items=50)
    jstore, tstore, jt, tt = _pair(data, True, "float32")
    js = jt.init_state(jax.random.PRNGKey(0))
    js, _ = jt._epoch_jit(js, jt._device_train_data(jstore), jt.feature_tables(jstore))
    st = _state_np(js)
    rs = RecSys(data, net_type="mlp", n_factors=8, hidden_layers=HIDDEN, metadata_id_col=["cat"],
                device="cpu")
    rs.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"], model_state=st["model_state"])
    got = rs.evaluate(batch_size=128, eval_metrics=("loss", "auc"), verbose=False)
    want = jt.evaluate(js, jstore, batch_size=128, verbose=False)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["auc"] == want["auc"]
    rows = np.arange(12)
    _, jids = jfull_catalog_topk(jt.model, {"tables": js["tables"], "dense": js["dense"]},
                                 js["model_state"], jnp.asarray(rows, jnp.int32),
                                 jstore.schema.num_items, jt.feature_tables(jstore), top_k=7,
                                 chunk_size=16)
    users = rs.store.user_encoder.decode(rows)
    got_ids = rs.predict(users, top_k=7, prediction_batch_size=16, return_raw_ids=False)
    np.testing.assert_array_equal(got_ids, np.asarray(jids))


def test_wide_linear_trains_through_the_autograd_step_like_jax():
    """n_factors=128 is wider than the fused pairwise kernel's lanes: the
    port takes the autograd step, as JAX takes its XLA step; two epochs
    agree as the kernel route does (rtol=1e-5, atol=1e-6)."""
    data = _data(True, n=700)
    *_, tt, js, ts, losses = _fit_both(data, True, "float32", 2, net="linear", n_factors=128,
                                       jcfg=dict(pallas_step=False))
    assert not tt._fused
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5, atol=1e-6)
    _assert_trees(ts["tables"], js["tables"], 1e-5, 1e-6, "tables")
    _assert_trees(ts["emb_opt"], js["emb_opt"], 1e-5, 1e-6, "emb_opt")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_mlp_has_no_factor_vectors_and_predicts_through_the_chunked_scorer():
    rs = RecSys(_data(False), net_type="mlp", n_factors=8, hidden_layers=HIDDEN, device="cpu")
    rs.init_tables()
    with pytest.raises(ValueError, match="does not factorize"):
        rs.item_vectors()
    with pytest.raises(ValueError, match="does not factorize"):
        rs.user_vectors()
    users = rs.store.user_encoder.to_list()[:4]
    ids = rs.predict(users, top_k=3)
    assert ids.shape == (4, 3)
    assert rs.state["dense"]["layers"][0]["w"].shape == (16, HIDDEN[0])


def test_amp_linear_on_the_fused_kernel_still_raises():
    """AMP Linear now trains through the fused step's bf16 variant (on the
    CPU its plain version); the MLP still refuses sampled softmax."""
    rs = RecSys(_data(False), n_factors=8, device="cpu", use_amp=True)
    losses = rs.fit(verbose=False)
    assert rs.trainer._fused and rs.model.compute_dtype == torch.bfloat16
    assert len(losses) == 1 and np.isfinite(losses[0])
    mlp = RecSys(_data(False), net_type="mlp", n_factors=8, hidden_layers=HIDDEN, device="cpu",
                 use_amp=True)
    with pytest.raises(ValueError, match="factorizable"):
        mlp.fit(loss="sampled_softmax")


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_amp_mlp_epochs_on_card_track_cpu(cuda_device):
    """Same start, keys and static negatives: the card's epochs (every
    layer through kernels #6 and #7) against the CPU's plain versions,
    within the bf16 rtol=0.08 of the fit test."""
    data = _data(True, n=4000, n_users=300, n_items=500)
    store = prepare_data(data, "user_id", "item_id", metadata_id_col=["cat"])
    cfg = TrainConfig(batch_size=256, learning_rate=0.05)
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, ModelConfig(**_mlp_cfg("bfloat16"))), cfg, dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: state[k] for k in ("tables", "dense")}
        else:
            state["tables"] = {k: v.to(dev) for k, v in start["tables"].items()}
            state["dense"] = jax.tree.map(lambda t: t.to(dev), start["dense"])
            state["dense_opt"] = init_dense_opt("adam", state["dense"])
        before = ft.fused_tower_fwd.launches
        data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
        losses = []
        for e in range(2):
            state, loss = tr.train_epoch(state, data_d, feat, keys=torch.arange(6) + 7 * e)
            losses.append(float(loss))
        if dev != "cpu":
            steps = 2 * -(-store.num_train // 256)
            assert ft.fused_tower_fwd.launches - before == len(HIDDEN) * steps
        out[str(dev)] = losses
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0.08)

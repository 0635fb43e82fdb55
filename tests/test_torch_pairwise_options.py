"""The rest of the pairwise training surface on the port against the JAX
package: K negatives per positive, popularity sampling, ``adaptive_hinge``
and ``warp``, and the unfused embedding update
(``embedding_optimizer="sgd"``, ``fused_embedding_update=False``).

JAX's threefry draws cannot be reproduced in torch, so every comparison
hands the port the JAX package's own negatives: ``Trainer._sample_negs``
called on the batches JAX builds (its round keys, its stable in-batch sort
by user, its step counter), passed to the port's step or epoch. Tables,
accumulators and losses then agree within rtol=1e-5, atol=1e-6, the epoch
parity tolerance; with K draws a row often occurs twice in one step, and
the scatter-adds of those duplicates in another order stay inside it.
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
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train import losses as jlosses
from torchrecsys_tpu.train.optim import apply_embedding_updates as japply
from torchrecsys_tpu.train.optim import augment_tables as jaugment
from torchrecsys_tpu.train.optim import split_augmented as jsplit
from torchrecsys_tpu.utils.permute import random_permutation as jperm
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train import losses as tlosses
from torchrecsys_tpu_torch.train.optim import apply_embedding_updates, augment_tables, split_augmented
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests.test_torch_mlp import _assert_trees, _state_np
from tests.test_torch_train import _data, _round_keys

RTOL, ATOL = 1e-5, 1e-6
LOSSES = ["hinge", "bpr", "logistic", "adaptive_hinge", "warp"]


def _pair(net, meta, tcfg, jcfg=None, data=None, n_factors=8):
    data = _data(meta) if data is None else data
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = dict(net_type=net, n_factors=n_factors, neucf_hidden_layers=(16, 8))
    base = dict(batch_size=128, learning_rate=0.05, seed=3, dense_optimizer="adagrad")
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(**base, **tcfg, **(jcfg or {})))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)), TrainConfig(**base, **tcfg), "cpu")
    return jstore, tstore, jt, tt


def _assert_state(ts, js, what=""):
    for name in js["tables"]:
        np.testing.assert_allclose(ts["tables"][name].numpy(), np.asarray(js["tables"][name]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} table {name}")
        if "acc" in js["emb_opt"][name]:
            np.testing.assert_allclose(ts["emb_opt"][name]["acc"].numpy(),
                                       np.asarray(js["emb_opt"][name]["acc"]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{what} acc {name}")
        else:
            assert ts["emb_opt"][name] == {}


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["adaptive_hinge", "warp"])
def test_k_negative_losses_and_gradients_match_jax(name, k):
    """Values and ``jax.grad`` of both inputs: tied negatives (a draw
    repeated, so tied maxima share the gradient), hinge-kink rows, rows
    with no violator."""
    r = np.random.default_rng(k)
    pos = r.normal(size=64).astype(np.float32)
    neg = r.normal(size=(k, 64)).astype(np.float32)
    if k > 1:
        neg[1, :12] = neg[0, :12]
    neg[0, 12:16] = pos[12:16] - 1.0
    neg[:, 20:26] = pos[20:26] - 5.0
    jf, tf = jlosses.get_loss(name, 1000), tlosses.get_loss(name, 1000)
    jv, (gp, gn) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(neg), 1.0)
    tp, tn = torch.from_numpy(pos).requires_grad_(), torch.from_numpy(neg).requires_grad_()
    tv = tf(tp, tn, 1.0)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), rtol=1e-6, atol=1e-7)
    per_row = tlosses.get_per_row_loss(name, 1000)(tp.detach(), tn.detach(), 1.0)
    np.testing.assert_allclose(
        per_row.numpy(), np.asarray(jlosses.get_per_row_loss(name, 1000)(pos, neg, 1.0)),
        rtol=1e-6, atol=1e-7,
    )
    assert float(per_row[20:26].abs().max()) == 0.0


def test_warp_needs_the_catalog_size():
    with pytest.raises(ValueError, match="num_items"):
        tlosses.get_per_row_loss("warp")
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get_loss("nope")


# ---------------------------------------------------------------------------
# one K=4 step: every model and loss
# ---------------------------------------------------------------------------


def _batch(store, b=48, seed=0):
    """One weighted batch of distinct users and positives (the last 5 rows
    weigh 0)."""
    g = np.random.default_rng(seed)
    users = g.choice(store.schema.num_users, b, replace=False)
    pos = g.choice(store.schema.num_items, b, replace=False)
    return users, pos, (np.arange(b) < b - 5).astype(np.float32)


def _warm(js, seed=7):
    """The state with accumulators drawn in [0.05, 0.15), as after some
    training."""
    g = np.random.default_rng(seed)
    emb_opt = {k: {"acc": jnp.asarray(g.uniform(0.05, 0.15, o["acc"].shape).astype(np.float32))}
               for k, o in js["emb_opt"].items()}
    return dict(js, emb_opt=emb_opt)


MODELS = [("linear", False), ("linear", True), ("fm", False), ("fm", True), ("neucf", False)]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("net, meta", MODELS, ids=[f"{n}-{'meta' if m else 'plain'}" for n, m in MODELS])
def test_k4_step_matches_jax_train_step(net, meta, loss):
    """JAX's ``train_step`` (the unfused update: rowwise adagrad with the
    accumulator after every duplicate) draws 4 negatives per row in the
    step; the port's autograd step takes those draws, on copies of the
    plain tables and accumulators. Tables, accumulators, the dense layers
    (NeuCF, adagrad) and the loss. The accumulators start where training
    leaves them (``_warm``): from zero, adagrad's first step
    ``g / sqrt(g^2 + 1e-10)`` turns the rounding of a gradient that cancels
    (Linear's user bias under a pairwise loss: it adds to both scores) into
    a move of up to ``lr``, in either package."""
    data = _data(meta, n=3000, n_users=300, n_items=600)
    jstore, tstore, jt, tt = _pair(net, meta, dict(loss=loss, num_negatives=4), data=data)
    assert not tt._fused and tt._in_step_negs
    js = _warm(jt.init_state(jax.random.PRNGKey(0)))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer="adagrad")
    users, pos, w = _batch(tstore)
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    jbatch = {"user_id": jnp.asarray(users, jnp.int32), "pos_item_id": jnp.asarray(pos, jnp.int32),
              "_w": jnp.asarray(w)}
    negs = np.asarray(jt._sample_negs(js["rng"], js["step"], jbatch["pos_item_id"], jfeat))
    assert negs.shape == (4, 48)
    js2, jloss = jax.jit(jt.train_step)(js, jbatch, jfeat)
    tables = {k: v.clone() for k, v in ts["tables"].items()}
    emb_opt = {k: {"acc": o["acc"].clone()} for k, o in ts["emb_opt"].items()}
    tloss = tt.pairwise_step(ts, tables, *(torch.as_tensor(a) for a in (users, pos, negs, w)),
                             float(w.sum()), tfeat, lr=0.05, emb_opt=emb_opt)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    _assert_state(dict(ts, tables=tables, emb_opt=emb_opt), js2)
    if net == "neucf":
        _assert_trees(ts["dense"], js2["dense"], RTOL, ATOL, "dense")
    assert int(np.unique(negs).size) < negs.size  # duplicates were drawn


@pytest.mark.parametrize("net, loss", [("linear", "warp"), ("neucf", "adaptive_hinge")])
def test_k4_step_on_the_augmented_tables_matches_jax(net, loss):
    """The epoch's layout: JAX's step body on the augmented tables
    (``_step_impl(fused=True)``, each duplicate scaled by its own
    accumulator) against the port's step on ``augment_tables``."""
    data = _data(True, n=3000, n_users=300, n_items=600)
    jstore, tstore, jt, tt = _pair(net, True, dict(loss=loss, num_negatives=4), data=data)
    js = _warm(jt.init_state(jax.random.PRNGKey(1)))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer="adagrad")
    users, pos, w = _batch(tstore, seed=1)
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    jbatch = {"user_id": jnp.asarray(users, jnp.int32), "pos_item_id": jnp.asarray(pos, jnp.int32),
              "_w": jnp.asarray(w)}
    negs = np.asarray(jt._sample_negs(js["rng"], js["step"], jbatch["pos_item_id"], jfeat))
    jaug = dict(js, tables=jaugment(js["tables"], js["emb_opt"]))
    js2, jloss = jax.jit(lambda s, b, f: jt._step_impl(s, b, f, fused=True))(jaug, jbatch, jfeat)
    tables, emb_opt = jsplit(js2["tables"])
    aug = augment_tables(ts["tables"], ts["emb_opt"])
    tloss = tt.pairwise_step(ts, aug, *(torch.as_tensor(a) for a in (users, pos, negs, w)),
                             float(w.sum()), tfeat, lr=0.05)
    t_tables, t_opt = split_augmented(aug)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    _assert_state(dict(ts, tables=t_tables, emb_opt=t_opt), dict(js2, tables=tables, emb_opt=emb_opt))


# ---------------------------------------------------------------------------
# epochs with JAX's draws
# ---------------------------------------------------------------------------


def _jax_epoch_negs(jt, jstate, jdata, jfeat):
    """The negatives JAX's epoch draws in its steps: its permutation of the
    split (round keys from ``state["rng"]``), the wrap-around pad, the
    stable in-batch sort by user, then ``_sample_negs`` at each global
    step. (nb, b) or (nb, K, b), as the port's ``train_epoch`` takes
    them."""
    n = int(jdata["user_id"].shape[0])
    b = min(jt.cfg.batch_size, n)
    rng, k_shuffle = jax.random.split(jstate["rng"])
    full = jperm(k_shuffle, n)
    if n % b == 0:
        nb, perm = n // b, full
    else:
        nb = -(-n // b)
        perm = jnp.concatenate([full, full[: nb * b - n]])
    user = jnp.take(jdata["user_id"], perm).reshape(nb, b)
    pos = jnp.take(jdata["pos_item_id"], perm).reshape(nb, b)
    pos = jnp.take_along_axis(pos, jnp.argsort(user, axis=1), axis=1)
    negs = [jt._sample_negs(rng, jstate["step"] + i, pos[i], jfeat) for i in range(nb)]
    return torch.from_numpy(np.asarray(jnp.stack(negs)).astype(np.int64))


def _epochs(jstore, tstore, jt, tt, epochs=2, check_state=True):
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu", dense_optimizer="adagrad")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    assert "neg_item_id" not in tdata or not tt._in_step_negs
    for _ in range(epochs):
        keys = _round_keys(jstate["rng"])
        negs = _jax_epoch_negs(jt, jstate, jdata, jfeat) if jt._in_step_negs else None
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys, negatives=negs)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    assert tstate["step"] == int(jstate["step"])
    if check_state:
        _assert_state(tstate, jstate)
    return jstate, tstate


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_popularity_k1_epochs_match_jax_kernel_path(meta):
    """Popularity draws at K=1 keep the fused step: two epochs against
    JAX's kernel path (``pallas_step=True``, interpret mode), JAX's round
    keys and alias draws handed over."""
    jstore, tstore, jt, tt = _pair("linear", meta, dict(neg_sampling="popularity"),
                                   dict(pallas_step=True), n_factors=16)
    assert jt._pallas_pairwise() and tt._fused and tt._in_step_negs
    _epochs(jstore, tstore, jt, tt)


def test_warp_k4_popularity_epochs_match_jax():
    """The bench row's options at a small size (``warp``, K=4, popularity):
    two epochs of the autograd step against JAX's XLA step."""
    jstore, tstore, jt, tt = _pair("linear", True, dict(loss="warp", num_negatives=4,
                                                         neg_sampling="popularity"))
    _epochs(jstore, tstore, jt, tt)


@pytest.mark.parametrize("tcfg", [dict(embedding_optimizer="sgd"), dict(fused_embedding_update=False)],
                         ids=["sgd", "unfused_adagrad"])
def test_unfused_update_epochs_match_jax(tcfg):
    """The unfused update on the plain tables (JAX's ``apply_embedding_
    updates``): Linear with metadata, hinge, static negatives, two
    epochs."""
    jstore, tstore, jt, tt = _pair("linear", True, tcfg, dict(pallas_step=False))
    assert not tt._fused
    _epochs(jstore, tstore, jt, tt)


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "sgd"])
def test_apply_embedding_updates_matches_jax_with_duplicates(kind):
    """Two sites on one table, many duplicate ids: adagrad reads each row's
    accumulator after every duplicate's mean square has been added."""
    g = np.random.default_rng(5)
    table = g.normal(size=(20, 6)).astype(np.float32)
    acc = g.uniform(0, 1, size=20).astype(np.float32)
    sites = [(g.integers(0, 20, (30,)), g.normal(size=(30, 6)).astype(np.float32)),
             (g.integers(0, 20, (10, 3)), g.normal(size=(10, 3, 6)).astype(np.float32))]
    jstate = {"t": {"acc": jnp.asarray(acc)}} if kind != "sgd" else {"t": {}}
    jt_, jo = japply(kind, 0.05, {"t": jnp.asarray(table)}, jstate,
                     {"t": [(jnp.asarray(i), jnp.asarray(x)) for i, x in sites]})
    tt_ = {"t": torch.from_numpy(table.copy())}
    to = {"t": {"acc": torch.from_numpy(acc.copy())}} if kind != "sgd" else {"t": {}}
    apply_embedding_updates(kind, 0.05, tt_, to, {"t": [(torch.from_numpy(i), torch.from_numpy(x))
                                                        for i, x in sites]})
    np.testing.assert_allclose(tt_["t"].numpy(), np.asarray(jt_["t"]), rtol=RTOL, atol=ATOL)
    if kind != "sgd":
        np.testing.assert_allclose(to["t"]["acc"].numpy(), np.asarray(jo["t"]["acc"]), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# evaluate with K draws; the facade
# ---------------------------------------------------------------------------


def _jax_eval_negs(jt, jstate, jstore, jfeat, b):
    """JAX's evaluate draws: ``_sample_negs(rng, 0x5EED + i)`` on each
    wrap-padded batch; (K, n) for the n test rows."""
    n = jstore.num_test
    nb = -(-n // b)
    pos = np.asarray(jstore.test_arrays()["pos_item_id"])
    pos = np.concatenate([pos, pos[: nb * b - n]]).reshape(nb, b)
    negs = [np.asarray(jt._sample_negs(jstate["rng"], 0x5EED + i, jnp.asarray(pos[i]), jfeat))
            for i in range(nb)]
    return np.concatenate(negs, axis=-1)[..., :n]


@pytest.mark.parametrize("sampling", ["uniform", "popularity"])
def test_k4_evaluate_matches_jax_with_its_draws(sampling):
    """The loss over the 4 draws, the AUC against the first."""
    jstore, tstore, jt, tt = _pair("linear", True, dict(loss="warp", num_negatives=4,
                                                         neg_sampling=sampling))
    js = jt.init_state(jax.random.PRNGKey(2))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer="adagrad")
    want = jt.evaluate(js, jstore, batch_size=50, verbose=False)
    negs = _jax_eval_negs(jt, js, jstore, jt.feature_tables(jstore), 50)
    assert negs.shape == (4, jstore.num_test)
    got = tt.evaluate(ts, tstore, batch_size=50, verbose=False, negatives=negs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL)
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    with pytest.raises(ValueError, match=r"4 item rows per test row"):
        tt.evaluate(ts, tstore, negatives=negs[0])
    # the port's own seeded draws: the same on every call
    assert tt.evaluate(ts, tstore, verbose=False) == tt.evaluate(ts, tstore, verbose=False)


@pytest.mark.parametrize("kw", [
    dict(num_negatives=8), dict(neg_sampling="popularity"), dict(loss="warp", num_negatives=3),
    dict(loss="adaptive_hinge", num_negatives=3), dict(embedding_optimizer="sgd"),
    dict(lr_schedule={"kind": "exponential", "transition_steps": 3, "decay_rate": 0.5}),
    dict(lr_schedule={"kind": "cosine", "decay_steps": 10, "alpha": 0.1}),
    dict(lr_schedule={"kind": "step", "boundaries_and_scales": {3: 0.5}}),
    dict(lr_schedule={"kind": "linear", "transition_steps": 8, "end_value": 0.01}),
    dict(lr_schedule=lambda step: 0.05 / (1 + step)),
], ids=["k8", "popularity", "warp", "adaptive_hinge", "sgd", "exponential", "cosine", "step", "linear",
        "callable"])
def test_recsys_fits_evaluates_and_predicts_under_each_option(kw):
    rs = RecSys(_data(True), metadata_id_col=["cat"], n_factors=8, device="cpu",
                dynamic_neg_sampling=True)
    losses = rs.fit(epochs=2, batch_size=128, learning_rate=0.05, verbose=False, **kw)
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = rs.evaluate(eval_metrics=("loss", "auc", "recall@5"), verbose=False)
    assert all(np.isfinite(v) for v in out.values())
    assert rs.predict(rs.store.user_encoder.to_list()[:3], top_k=4).shape == (3, 4)


def test_unfused_trainer_config_fits_through_the_facade_state():
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    tr = rs._ensure_trainer(TrainConfig(batch_size=128, fused_embedding_update=False))
    assert not tr._fused
    state, losses = tr.fit(tr.init_state(), rs.store, epochs=1, verbose=False)
    rs._install(state)
    assert np.isfinite(losses).all() and rs.predict([0, 1], top_k=3).shape == (2, 3)
    assert bool((state["emb_opt"]["item"]["acc"] > 0).any())

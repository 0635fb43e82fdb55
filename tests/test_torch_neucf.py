"""NeuCF on the port (torchrecsys_tpu_torch/models/neucf.py) against the
JAX package's ``NeuCFModel``.

The score from the same tables and dense layers (f32 within rtol=1e-5,
atol=1e-6; bf16 by the AMP rule of tests/test_torch_amp.py), two epochs
of the autograd pairwise step against JAX's XLA step (f32 tight, bf16 by
the AMP rule), evaluate with JAX's K=4 draws handed over, predict through
the chunked scorer against JAX's ``full_catalog_topk``, the dense layers'
carry-over, and the refusals NeuCF shares with JAX (it does not
factorize).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.data.features import attach_features as jattach
from torchrecsys_tpu.eval.predict import full_catalog_topk as jfull_catalog_topk
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.data.features import attach_features as tattach
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils.convert import dense_from_jax, train_state_from_jax

from tests.test_torch_amp import _mostly_close
from tests.test_torch_mlp import _assert_trees, _state_np
from tests.test_torch_pairwise_options import _jax_eval_negs
from tests.test_torch_train import _data, _round_keys

HIDDEN = (16, 8)


def _pair(meta, compute="float32", tcfg=None, data=None, hidden=HIDDEN):
    data = _data(meta) if data is None else data
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = dict(net_type="neucf", n_factors=8, neucf_hidden_layers=hidden, compute_dtype=compute)
    base = dict(batch_size=128, learning_rate=0.05, seed=3, **(tcfg or {}))
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(**base))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)), TrainConfig(**base), "cpu")
    return jstore, tstore, jt, tt


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_scores_match_jax(meta, compute):
    jstore, tstore, jt, tt = _pair(meta, compute)
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu")
    assert tt.model.table_specs()["user"].dim == 16 and tt.model.user_gather_sites == {"user"}
    rows = np.arange(200)
    users, items = rows % tstore.schema.num_users, (rows * 7) % tstore.schema.num_items
    jside = jattach({"user_id": jnp.asarray(users, jnp.int32), "item_id": jnp.asarray(items, jnp.int32)},
                    jt.feature_tables(jstore))
    tside = tattach({"user_id": torch.as_tensor(users), "item_id": torch.as_tensor(items)},
                    tt.feature_tables(tstore))
    want, _ = jt.model.score({"tables": js["tables"], "dense": js["dense"]}, js["model_state"], jside)
    got, st = tt.model.score({"tables": ts["tables"], "dense": ts["dense"]}, ts["model_state"], tside)
    assert got.dtype == torch.float32 and st is ts["model_state"]
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        _mostly_close(got.numpy(), np.asarray(want), rtol=5e-2, atol=5e-3, msg="bf16 scores")


def _epochs(jstore, tstore, jt, tt, epochs=2):
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
    return js, ts, np.asarray(losses)


def test_f32_epochs_match_jax():
    """Two epochs with metadata and the dense optimizer adagrad (adam's
    first step turns the rounding of a gradient that cancels, the output
    bias under a pairwise loss, into a step of up to lr)."""
    jstore, tstore, jt, tt = _pair(True, tcfg=dict(dense_optimizer="adagrad"))
    assert not tt._fused
    js, ts, losses = _epochs(jstore, tstore, jt, tt)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5, atol=1e-6)
    _assert_trees(ts["tables"], js["tables"], 1e-5, 1e-6, "tables")
    _assert_trees(ts["emb_opt"], js["emb_opt"], 1e-5, 1e-6, "emb_opt")
    _assert_trees(ts["dense"], js["dense"], 1e-5, 1e-6, "dense")


def test_amp_epochs_track_jax():
    """bf16 compute, two epochs, by the AMP rule (dense adagrad, as in the
    f32 test)."""
    jstore, tstore, jt, tt = _pair(False, "bfloat16", tcfg=dict(dense_optimizer="adagrad"))
    js, ts, losses = _epochs(jstore, tstore, jt, tt)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=2e-2, atol=2e-3)
    for name in js["tables"]:
        _mostly_close(ts["tables"][name].numpy(), np.asarray(js["tables"][name]), 5e-2, 5e-3,
                      msg=f"table {name}")


def test_k4_evaluate_with_jax_draws_and_predict_match_jax():
    """After one JAX epoch: evaluate with JAX's 4 draws per test row (the
    loss over all, the AUC on the first), then predict's ids against JAX's
    chunked scorer."""
    data = _data(True, n=1500, n_users=60, n_items=50)
    jstore, tstore, jt, tt = _pair(True, tcfg=dict(loss="adaptive_hinge", num_negatives=4), data=data,
                                   hidden=(64, 32))  # the facade's default
    js = jt.init_state(jax.random.PRNGKey(0))
    js, _ = jt._epoch_jit(js, jt._device_train_data(jstore), jt.feature_tables(jstore))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu")
    want = jt.evaluate(js, jstore, batch_size=64, verbose=False)
    negs = _jax_eval_negs(jt, js, jstore, jt.feature_tables(jstore), 64)
    got = tt.evaluate(ts, tstore, batch_size=64, verbose=False, negatives=negs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    st = _state_np(js)
    rs = RecSys(data, net_type="neucf", n_factors=8, metadata_id_col=["cat"], device="cpu")
    rs.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"])
    rows = np.arange(12)
    _, jids = jfull_catalog_topk(jt.model, {"tables": js["tables"], "dense": js["dense"]},
                                 js["model_state"], jnp.asarray(rows, jnp.int32),
                                 jstore.schema.num_items, jt.feature_tables(jstore), top_k=7,
                                 chunk_size=16)
    got_ids = rs.predict(rs.store.user_encoder.decode(rows), top_k=7, prediction_batch_size=16,
                         return_raw_ids=False)
    np.testing.assert_array_equal(got_ids, np.asarray(jids))


def test_dense_layers_carry_over_from_jax_init_state():
    jstore, tstore, jt, tt = _pair(True)
    js = _state_np(jt.init_state(jax.random.PRNGKey(4)))
    dense = dense_from_jax(js["dense"], tt.model, "cpu")
    _assert_trees(dense, js["dense"], 0, 0, "dense")
    assert [tuple(l["w"].shape) for l in dense["layers"]] == [(24, 16), (16, 8)]
    assert tuple(dense["out"]["w"].shape) == (16, 1)
    bad = dict(js["dense"], out={"w": js["dense"]["out"]["w"][:4], "b": js["dense"]["out"]["b"]})
    with pytest.raises(ValueError, match=r"dense\['out'\]\['w'\]"):
        dense_from_jax(bad, tt.model, "cpu")


def test_facade_fits_evaluates_predicts_and_refuses_the_softmax():
    rs = RecSys(_data(True), net_type="neucf", metadata_id_col=["cat"], n_factors=8, device="cpu",
                dynamic_neg_sampling=True)
    with pytest.raises(ValueError, match="factorizable"):
        rs.fit(loss="sampled_softmax")
    losses = rs.fit(epochs=2, batch_size=128, learning_rate=0.05, verbose=False)
    assert np.isfinite(losses).all() and not rs.trainer._fused
    out = rs.evaluate(eval_metrics=("loss", "auc", "ndcg@5"), verbose=False)
    assert all(np.isfinite(v) for v in out.values())
    assert rs.predict(rs.store.user_encoder.to_list()[:4], top_k=3).shape == (4, 3)
    with pytest.raises(ValueError, match="does not factorize"):
        rs.item_vectors()
    assert [tuple(l["w"].shape) for l in rs.state["dense"]["layers"]] == [(24, 64), (64, 32)]


def test_similar_items_match_jax_at_the_default_width():
    """similar_items at the default n_factors=80: the item table is 2 x 80
    = 160 wide, so on the card the top-k kernels score it in two 128-lane
    slabs; here their plain version, against JAX's RecSys from the same
    tables."""
    from torchrecsys_tpu import RecSys as JRecSys

    data = _data(False)
    jrs = JRecSys(data, net_type="neucf")
    jrs.fit(epochs=1, batch_size=128, verbose=False)
    tables = {k: np.asarray(v) for k, v in jrs.state["tables"].items()}
    rs = RecSys(data, net_type="neucf", device="cpu")
    rs.load_jax_tables(tables)
    assert rs.state["tables"]["item"].shape[1] == 160
    for item in jrs.store.item_encoder.to_list()[:8]:
        np.testing.assert_array_equal(rs.similar_items(item, top_k=7), jrs.similar_items(item, top_k=7))

"""The LSTM sequence model on the port (torchrecsys_tpu_torch/models/lstm.py,
models/sequence.py) against the JAX package's ``LSTMModel``; the helpers
here also drive tests/test_torch_sasrec.py.

The same numpy-seeded data go through both packages; the port starts from
JAX's tables and dense tree (utils/convert.py) and, where JAX draws,
takes its draws. Tolerances:

- f32 encodings and scores: rtol=1e-5, atol=1e-6 (the same products summed
  in another order);
- f32 fits (two epochs, hinge with the store's static negatives or sampled
  softmax): epoch losses, tables, accumulators and the dense tree within
  rtol=2e-4, atol=1e-5: every history row of a batch scatters into the
  item table, so a row occurs many times per step and f32 scatter-adds in
  another order, and the encoder's gradient is a sum over L steps;
- bf16 compute (``use_amp``): the AMP rule of tests/test_torch_amp.py
  (losses within rtol=2e-2, atol=2e-3; values through ``_mostly_close``,
  rtol=5e-2, atol=5e-3 on 98% of the elements); SASRec's values by the
  noise-floor rule of ``_amp_noise_floor``;
- evaluate: loss and AUC within rtol=1e-5, atol=1e-6; ranking metrics and
  predicted ids exactly in f32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.data.features import attach_features as jattach
from torchrecsys_tpu.eval import predict as jpred
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.utils.checkpoint import load_aux as jload_aux
from torchrecsys_tpu.utils.checkpoint import pack_store_aux as jpack_store_aux
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.data.features import attach_features as tattach
from torchrecsys_tpu_torch.eval import predict as tpred
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils.checkpoint import load_aux, pack_store_aux
from torchrecsys_tpu_torch.utils.convert import checkpoint_from_jax, dense_opt_from_jax, train_state_from_jax

from tests.test_torch_amp import _mostly_close
from tests.test_torch_mlp import _assert_trees, _flat, _state_np
from tests.test_torch_pairwise_options import _jax_eval_negs
from tests.test_torch_train import _round_keys

L = 5
FIT_RTOL, FIT_ATOL = 2e-4, 1e-5
# The AMP fits train the dense tree with adagrad: adam divides each
# gradient by its own running magnitude, so a weight whose bf16 gradient
# is near zero steps by up to lr in a direction set by the rounding
# (tests/test_torch_neucf.py's AMP fit does the same).
AMP_DENSE_OPT = "adagrad"


def seq_data(n=500, n_users=70, n_items=60, seed=0):
    """Users with a few to many interactions: full, partial and (users whose
    rows all land in the test split) empty history windows."""
    r = np.random.default_rng(seed)
    users = np.minimum(r.geometric(0.04, n) - 1, n_users - 1)
    return {"user_id": users, "item_id": r.integers(0, n_items, n)}


def mcfg(net, compute="float32", **kw):
    return dict(net_type=net, n_factors=8, history_len=L, compute_dtype=compute, **kw)


def seq_pair(net, compute="float32", tcfg=None, data=None, **kw):
    data = seq_data() if data is None else data
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False)
    base = dict(batch_size=64, learning_rate=0.05, seed=3, **(tcfg or {}))
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg(net, compute, **kw))), JTrainConfig(**base))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg(net, compute, **kw))), TrainConfig(**base), "cpu")
    return jstore, tstore, jt, tt


def carried(jt, tt, key=0):
    js = jt.init_state(jax.random.PRNGKey(key))
    return js, train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer=tt.cfg.dense_optimizer)


def _masks():
    return {
        "left_padded": [[0, 0, 1, 1, 1], [0, 0, 0, 0, 1]],
        "interleaved": [[1, 0, 1, 0, 1], [0, 1, 1, 0, 0]],
        "empty": [[0, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
    }


def check_encode(net, kind, compute):
    """``_encode`` of both packages on the same history rows and masks."""
    _, _, jt, tt = seq_pair(net, compute)
    js, ts = carried(jt, tt)
    r = np.random.default_rng(1)
    emb = r.normal(size=(6, L, 8)).astype(np.float32) * 0.5
    mask = np.asarray(_masks()[kind] * 3, bool)
    want = np.asarray(jt.model._encode(js["dense"], jnp.asarray(emb), jnp.asarray(mask)), np.float32)
    got = tt.model._encode(ts["dense"], torch.from_numpy(emb), torch.from_numpy(mask)).float().numpy()
    assert got.shape == (6, 8)
    if kind == "empty" and net == "sasrec":
        assert not got[0].any() and not want[0].any()  # an empty history encodes to zeros
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        _mostly_close(got, want, rtol=5e-2, atol=5e-3, msg="bf16 encodings")


def check_score_rows(net, k):
    """Scores of a generic side (k=0: every row hides its own candidate)
    and of paired sides with k negative blocks (one encoding per pair with
    the positive hidden, tiled over the blocks)."""
    jstore, tstore, jt, tt = seq_pair(net)
    js, ts = carried(jt, tt)
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    np.testing.assert_array_equal(tfeat["hist_ids"].numpy(), np.asarray(jfeat["hist_ids"]))
    np.testing.assert_array_equal(tfeat["hist_mask"].numpy(), np.asarray(jfeat["hist_mask"]))
    r = np.random.default_rng(2)
    b, n_items = 40, tstore.schema.num_items
    users = r.integers(0, tstore.schema.num_users, b)
    # positives drawn from each user's own history: the leakage mask bites
    hist = tfeat["hist_ids"].numpy()[users]
    pos = np.where(tfeat["hist_mask"].numpy()[users, -1], hist[:, -1], r.integers(0, n_items, b))
    jparams = {"tables": js["tables"], "dense": js["dense"]}
    tparams = {"tables": ts["tables"], "dense": ts["dense"]}
    if k == 0:
        jside = jattach({"user_id": jnp.asarray(users, jnp.int32), "item_id": jnp.asarray(pos, jnp.int32)}, jfeat)
        tside = tattach({"user_id": torch.as_tensor(users), "item_id": torch.as_tensor(pos)}, tfeat)
    else:
        negs = hist[:, :k].T if k > 1 else hist[:, 0]  # negatives that sit in the history
        jside = jt._paired_side(jnp.asarray(users, jnp.int32), jnp.asarray(pos, jnp.int32),
                                jnp.asarray(negs, jnp.int32), jfeat)
        tside = tt._paired_side(torch.as_tensor(users), torch.as_tensor(pos), torch.as_tensor(negs), tfeat)
        assert tside["_pair_b"] == b and tt.model.gathers(tside)["hist"][1].shape == (b, L)
    want, _ = jt.model.score(jparams, js["model_state"], jside)
    got, _ = tt.model.score(tparams, ts["model_state"], tside)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if k:  # a negative block scores against the positive-masked encoding
        h = tt.model._encode(ts["dense"], ts["tables"]["item"][tside["hist_ids"][:b]],
                             tside["hist_mask"][:b] & (tside["hist_ids"][:b] != torch.as_tensor(pos)[:, None]))
        item, ib = ts["tables"]["item"], ts["tables"]["item_bias"][:, 0]
        neg0 = torch.as_tensor(negs if k == 1 else negs[0])
        torch.testing.assert_close(got[b:2 * b], torch.sum(h * item[neg0], -1) + ib[neg0])


def check_pair_vectors(net):
    jstore, tstore, jt, tt = seq_pair(net)
    js, ts = carried(jt, tt)
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    users, pos = np.asarray(tstore.train_users[:48]), np.asarray(tstore.train_items[:48])
    jside = jattach({"user_id": jnp.asarray(users), "item_id": jnp.asarray(pos)}, jfeat)
    tside = tattach({"user_id": torch.as_tensor(users).long(), "item_id": torch.as_tensor(pos).long()}, tfeat)
    want = jt.model.pair_vectors(js["dense"], js["model_state"], jt.model.gather_rows(js["tables"], jside),
                                 jside, train=True)
    got = tt.model.pair_vectors(ts["dense"], ts["model_state"], tt.model.gather_rows(ts["tables"], tside),
                                tside, train=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def check_fit(net, loss, compute, dense_optimizer="adam", **kw):
    """Two epochs from JAX's start with JAX's round keys: hinge on the
    store's static negatives (the autograd pairwise step), or sampled
    softmax (the CE kernels' plain versions here)."""
    jstore, tstore, jt, tt = seq_pair(net, compute, dict(loss=loss, dense_optimizer=dense_optimizer), **kw)
    assert not tt._fused
    js, ts = carried(jt, tt)
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    losses = []
    for _ in range(2):
        keys = _round_keys(js["rng"])
        js, jloss = jt._epoch_jit(js, jdata, jfeat)
        ts, tloss = tt.train_epoch(ts, tdata, tfeat, keys=keys)
        losses.append((float(tloss), float(jloss)))
    losses = np.asarray(losses)
    assert ts["step"] == int(js["step"])
    if compute == "float32":
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=FIT_RTOL, atol=FIT_ATOL)
        _assert_trees(ts["tables"], js["tables"], FIT_RTOL, FIT_ATOL, "tables")
        _assert_trees(ts["emb_opt"], js["emb_opt"], FIT_RTOL, FIT_ATOL, "emb_opt")
        _assert_dense(ts, js, dense_optimizer, tt.cfg.learning_rate)
    elif net == "lstm":
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=2e-2, atol=2e-3)
        for name in js["tables"]:
            _mostly_close(ts["tables"][name].numpy(), np.asarray(js["tables"][name]), 5e-2, 5e-3,
                          msg=f"table {name}")
        for (name, a), (_, b) in zip(_flat(ts["dense"]), _flat(js["dense"])):
            _mostly_close(a, b, 5e-2, 5e-3, msg=f"dense {name}")
    else:
        np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=2e-2, atol=2e-3)
        witness, _ = check_fit(net, loss, "float32", dense_optimizer, **kw)
        _amp_noise_floor(ts, js, witness)
    return js, ts


def _amp_noise_floor(ts, js, jf32):
    """SASRec's AMP rule: the port's bf16 values differ from JAX's bf16
    values by no more than 3x JAX's own bf16 drift from its f32 fit (mean
    absolute difference per leaf). XLA on the CPU keeps f32 between the
    bf16 ops of a fused chain, the port rounds after each op as the card
    does, and SASRec's chains (layer norms, attention) are long: after two
    epochs about a fifth of the item table sits beyond the elementwise AMP
    rule in either direction, at the scale of bf16 itself."""
    pairs = [(f"table {k}", ts["tables"][k].numpy(), np.asarray(js["tables"][k]), np.asarray(jf32["tables"][k]))
             for k in js["tables"]]
    pairs += [(f"dense {n}", a, b, c) for (n, a), (_, b), (_, c) in
              zip(_flat(ts["dense"]), _flat(js["dense"]), _flat(jf32["dense"]))]
    for name, got, want, f32 in pairs:
        drift = np.abs(want - f32).mean()
        assert np.abs(got - want).mean() <= 3 * drift + 1e-7, name


def _assert_dense(ts, js, dense_optimizer, lr):
    """The dense trees at the f32 fit tolerance. SASRec's key bias (the
    middle third of each block's ``qkv`` bias) has a gradient of exactly 0
    (it adds ``q . b_k`` to every key's score alike, which the softmax
    cancels), so its gradient is rounding noise in both packages; adam
    divides that noise by its own magnitude and steps by up to lr. There it
    is held to that bound, 2 * lr per step, instead."""
    if "blocks" not in ts["dense"] or dense_optimizer != "adam":
        _assert_trees(ts["dense"], js["dense"], FIT_RTOL, FIT_ATOL, "dense")
        return
    skip = {f"['blocks'][{i}]['qkv']['b']" for i in range(len(ts["dense"]["blocks"]))}
    _assert_trees(ts["dense"], js["dense"], FIT_RTOL, FIT_ATOL, "dense", skip=skip)
    d = ts["dense"]["pos"].shape[1]
    for tb, jb in zip(ts["dense"]["blocks"], js["dense"]["blocks"]):
        got, want = tb["qkv"]["b"].numpy(), np.asarray(jb["qkv"]["b"])
        for part in (slice(0, d), slice(2 * d, 3 * d)):  # the query and value biases
            np.testing.assert_allclose(got[part], want[part], rtol=FIT_RTOL, atol=FIT_ATOL)
        assert np.abs(got[d:2 * d] - want[d:2 * d]).max() <= 2 * lr * ts["step"]


def check_evaluate(net, loss):
    """After one JAX epoch: Trainer.evaluate (the store's static test
    negatives under hinge; JAX's draws under sampled softmax) and the
    ranking metrics through the encode-once catalog."""
    jstore, tstore, jt, tt = seq_pair(net, tcfg=dict(loss=loss))
    js = jt.init_state(jax.random.PRNGKey(0))
    js, _ = jt._epoch_jit(js, jt._device_train_data(jstore), jt.feature_tables(jstore))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu")
    want = jt.evaluate(js, jstore, batch_size=32, verbose=False)
    negs = _jax_eval_negs(jt, js, jstore, jt.feature_tables(jstore), 32) if loss != "hinge" else None
    got = tt.evaluate(ts, tstore, batch_size=32, verbose=False, negatives=negs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    jparams = {"tables": js["tables"], "dense": js["dense"]}
    tparams = {"tables": ts["tables"], "dense": ts["dense"]}
    jfeat, tfeat = jt.feature_tables(jstore), tt.feature_tables(tstore)
    want = jpred.ranking_eval(jt.model, jparams, js["model_state"], jstore.test_users, jstore.test_items,
                              jstore.schema.num_items, jfeat, ks=(5, 10))
    got = tpred.ranking_eval(tt.model, tparams, ts["model_state"], tstore.test_users, tstore.test_items,
                             tstore.schema.num_items, tfeat, ks=(5, 10),
                             catalog=tt.model.linearized_catalog(tparams, tfeat))
    assert got == want


def check_predict(net):
    """The facades after one JAX fit: predict through the encode-once
    catalog (history unmasked), with exclude_seen, and the generic chunked
    scorer (every (user, candidate) row re-encoded with the candidate
    hidden) against JAX's."""
    data = seq_data()
    kw = dict(net_type=net, n_factors=8, history_len=L, seed=3)
    j = JRecSys(data, **kw)
    j.fit(epochs=1, batch_size=64, learning_rate=0.05, verbose=False)
    st = _state_np(j.state)
    t = RecSys(data, device="cpu", **kw)
    t.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"])
    users = j.store.user_encoder.to_list()[:12]
    np.testing.assert_array_equal(t.predict(users, top_k=7), j.predict(users, top_k=7))
    np.testing.assert_array_equal(t.predict(users, top_k=7, exclude_seen=True),
                                  j.predict(users, top_k=7, exclude_seen=True))
    vecs, const = t.user_vectors(users)
    jvecs, _ = j.user_vectors(users)
    np.testing.assert_allclose(vecs, jvecs, rtol=1e-5, atol=1e-6)
    assert not const.any()
    rows = np.arange(12)
    n = t.store.schema.num_items
    _, jids = jpred.full_catalog_topk(j.model, {"tables": j.state["tables"], "dense": j.state["dense"]},
                                      j.state["model_state"], jnp.asarray(rows, jnp.int32), n,
                                      j.trainer.feature_tables(j.store), top_k=7, chunk_size=16)
    _, tids = tpred.catalog_topk(t.model, t._params(), t.state["model_state"], torch.as_tensor(rows), n,
                                 t.feat, top_k=7, chunk_size=16, use_fused=False)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def check_pack_store_aux_history(net):
    data = seq_data()
    tstore = prepare_data(data, "user_id", "item_id")
    jstore = jprepare(data, "user_id", "item_id")
    got = pack_store_aux(tstore, ModelConfig(**mcfg(net)), None)
    want = jpack_store_aux(jstore, JModelConfig(**mcfg(net)), None)
    for k in ("ids", "mask"):
        assert got["history"][k].dtype == want["history"][k].dtype
        np.testing.assert_array_equal(got["history"][k], want["history"][k])
    assert got["history"]["ids"].shape == (tstore.schema.num_users, L)
    assert "history" not in pack_store_aux(tstore, ModelConfig(n_factors=8), None)


def check_jax_checkpoint_carried_across(net, tmp_path):
    """A JAX checkpoint of the net (history window 4) through
    checkpoint_from_jax: the window and SASRec's shape survive, the cold
    port serves JAX's ids from the checkpointed history, a fit goes on."""
    data = seq_data()
    j = JRecSys(data, net_type=net, n_factors=8, history_len=4, seed=1)
    j.fit(epochs=1, batch_size=64, verbose=False)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    j.save(jd)
    jcold = JRecSys.load(jd)
    with open(os.path.join(jd, "schema.json")) as f:
        schema = json.load(f)
    checkpoint_from_jax(pd, jax.tree.map(np.asarray, dict(jcold.state)), jload_aux(jd), schema)
    aux = load_aux(pd)
    for k in ("history_len", "sasrec_blocks", "sasrec_heads"):
        assert aux["model_cfg"][k] == jload_aux(jd)["model_cfg"][k], k
    cold = RecSys.load(pd, device="cpu")
    assert cold.model_cfg.history_len == cold.history_len == 4 and cold.store.num_train == 0
    np.testing.assert_array_equal(cold.feat["hist_ids"].numpy(), jload_aux(jd)["history"]["ids"])
    _assert_trees(cold.state["dense"], jcold.state["dense"], 0, 0, "dense")
    users = jcold.store.user_encoder.to_list()[:10]
    np.testing.assert_array_equal(cold.predict(users, top_k=5), jcold.predict(users, top_k=5))
    cold.update_data({"user_id": np.asarray([3, 13, 999]), "item_id": np.asarray([3, 13, 23])},
                     split_ratio=1.0)
    assert np.isfinite(cold.fit(epochs=1, batch_size=64, verbose=False)).all()


# ---------------------------------------------------------------------------
# the LSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["left_padded", "interleaved", "empty"])
def test_encode_matches_jax(kind, compute):
    check_encode("lstm", kind, compute)


@pytest.mark.parametrize("k", [0, 1, 3], ids=["generic", "paired_k1", "paired_k3"])
def test_score_rows_match_jax(k):
    check_score_rows("lstm", k)


def test_pair_vectors_match_jax():
    check_pair_vectors("lstm")


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_f32_epochs_match_jax(loss):
    check_fit("lstm", loss, "float32")


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_amp_epochs_track_jax(loss):
    check_fit("lstm", loss, "bfloat16", dense_optimizer=AMP_DENSE_OPT)


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_evaluate_matches_jax(loss):
    check_evaluate("lstm", loss)


def test_predict_matches_jax():
    check_predict("lstm")


def test_pack_store_aux_history_matches_jax():
    check_pack_store_aux_history("lstm")


def test_cold_load_serves_from_the_checkpointed_history(tmp_path):
    """fit, save, RecSys.load: the cold store has no interactions, its
    history window is the checkpoint's, and it serves the warm model's ids;
    the history is not rebuilt from the (empty) split."""
    data = seq_data()
    rs = RecSys(data, net_type="lstm", n_factors=8, history_len=L, seed=2, device="cpu")
    rs.fit(epochs=1, batch_size=64, verbose=False)
    d = str(tmp_path / "ck")
    rs.save(d)
    cold = RecSys.load(d, device="cpu")
    assert cold.store.num_train == 0 and cold.history_len == L
    assert torch.equal(cold.feat["hist_ids"], rs.feat["hist_ids"])
    assert torch.equal(cold.feat["hist_mask"], rs.feat["hist_mask"])
    users = rs.store.user_encoder.to_list()[:15]
    np.testing.assert_array_equal(cold.predict(users, top_k=6), rs.predict(users, top_k=6))


def test_partial_fit_matches_jax():
    """JAX's RecSys fits an epoch, takes new interactions and trains one
    more; the port grows its store by the same interactions (the merged
    history windows equal JAX's), takes JAX's grown state and trains that
    epoch with JAX's round keys."""
    base = seq_data()
    r = np.random.default_rng(5)
    new = {"user_id": r.integers(0, 90, 120), "item_id": r.integers(0, 75, 120)}
    kw = dict(net_type="lstm", n_factors=8, history_len=L, seed=3)
    fit_kw = dict(epochs=1, batch_size=64, learning_rate=0.05, verbose=False)
    j = JRecSys(base, **kw)
    j.fit(**fit_kw)
    j.update_data(new)
    t = RecSys(base, device="cpu", **kw)
    t.fit(**fit_kw)
    catalog = t._linearized()
    t.update_data(new)
    assert t._catalog is None and t._linearized() is not catalog
    jfeat = j.trainer.feature_tables(j.store)
    np.testing.assert_array_equal(t.feat["hist_ids"].numpy(), np.asarray(jfeat["hist_ids"]))
    np.testing.assert_array_equal(t.feat["hist_mask"].numpy(), np.asarray(jfeat["hist_mask"]))
    st = _state_np(j.state)
    t.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"])
    t.state["dense_opt"] = dense_opt_from_jax(st["dense_opt"], "adam", t.state["dense"], "cpu")
    t.state["step"] = int(st["step"])
    keys = _round_keys(j.state["rng"])
    js, jloss = j.trainer._epoch_jit(j.state, j.trainer._device_train_data(j.store), jfeat)
    tt = Trainer(t.model, TrainConfig(batch_size=64, learning_rate=0.05, seed=3), "cpu")
    ts, tloss = tt.train_epoch(t.state, tt._device_train_data(t.store), tt.feature_tables(t.store), keys=keys)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=FIT_RTOL, atol=FIT_ATOL)
    _assert_trees(ts["tables"], js["tables"], FIT_RTOL, FIT_ATOL, "tables")
    _assert_trees(ts["dense"], js["dense"], FIT_RTOL, FIT_ATOL, "dense")
    users = t.store.user_encoder.to_list()[-6:]  # new users among them
    t._install(ts)
    j.state = js
    np.testing.assert_array_equal(t.predict(users, top_k=5), j.predict(users, top_k=5))


def test_facade_fits_every_pairwise_loss():
    rs = RecSys(seq_data(), net_type="lstm", n_factors=8, history_len=L, device="cpu",
                dynamic_neg_sampling=True)
    for loss, k in (("hinge", 1), ("bpr", 1), ("logistic", 1), ("adaptive_hinge", 3), ("warp", 3)):
        losses = rs.fit(epochs=1, batch_size=64, loss=loss, num_negatives=k, verbose=False)
        assert np.isfinite(losses).all(), loss
    out = rs.evaluate(eval_metrics=("loss", "auc", "recall@5", "ndcg@5"), verbose=False)
    assert all(np.isfinite(v) for v in out.values())


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def check_card_launches(net, device):
    """Predict through the encode-once catalog launches top-k kernel #1
    (k <= 16) or #2 once per call; a sampled-softmax epoch launches the CE
    kernels #4/#5 once per step."""
    from torchrecsys_tpu_torch.ops import dot_topk as dt
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    rs = RecSys(seq_data(n=3000), net_type=net, n_factors=16, history_len=L, device=device)
    s0 = (sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches)
    rs.fit(epochs=1, batch_size=256, loss="sampled_softmax", verbose=False)
    steps = -(-rs.store.num_train // 256)
    assert (sce.softmax_ce_fwd.launches - s0[0], sce.softmax_ce_bwd.launches - s0[1]) == (steps, steps)
    users = rs.store.user_encoder.to_list()[:20]
    for k, fn in ((10, dt.dot_topk_small), (40, dt.dot_topk_large)):
        n0 = fn.launches
        ids = rs.predict(users, top_k=k, exclude_seen=True)
        assert fn.launches - n0 == 1 and ids.shape == (20, k)


@pytest.mark.gpu
def test_card_launches_the_kernels(cuda_device):
    check_card_launches("lstm", cuda_device)

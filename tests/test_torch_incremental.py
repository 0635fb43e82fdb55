"""Incremental training in the port (data/interactions.py::extend_store,
IdEncoder's freeze/thaw, MetadataTable.extend, InteractionStore.user_history,
train/trainer.py::grow_state, RecSys.update_data / partial_fit) against the
JAX package.

The data layer is held bit for bit: the same base dataset and new
interactions, through each package's prepare_data and extend_store, give
equal encoders, splits, negatives, metadata and history windows.
``grow_state`` keeps the trained rows bitwise and draws the new ones from
the port's generator, so it is held against JAX's with JAX's fresh rows
substituted for the port's. One epoch after ``update_data`` starts from
JAX's grown state (carried over with ``load_jax_tables``) on the store's
static negatives with JAX's round keys, at the epoch tolerances of
tests/test_torch_train.py (Linear: rtol=1e-5, atol=1e-6) and
tests/test_torch_mlp.py (the f32 MLP: rtol=2e-4, atol=1e-6).
"""

import jax
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data.interactions import extend_store as jextend
from torchrecsys_tpu.data.interactions import prepare_data as jprepare
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train.trainer import grow_state as jgrow
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data.encoder import IdEncoder
from torchrecsys_tpu_torch.data.interactions import extend_store, prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train.trainer import grow_state
from torchrecsys_tpu_torch.utils.convert import dense_opt_from_jax, train_state_from_jax

from tests.test_torch_train import _round_keys

HIDDEN = (32, 16)


def _cats(items, new=False):
    """A list-valued category column, static per item; new items draw from
    categories the base data does not have."""
    off = 20 if new else 0
    return np.asarray(
        [[int(i % 5) + off] + ([int(i % 3) + 5 + off] if i % 2 else []) for i in items], dtype=object
    )


def _base(n=600, n_users=50, n_items=60, seed=0, ids="int"):
    r = np.random.default_rng(seed)
    users, items = r.integers(0, n_users, n), r.integers(0, n_items, n)
    data = {"user_id": users * 10 + 3, "item_id": items * 10 + 3, "cat": _cats(items)}
    if ids == "str":
        data["user_id"] = np.asarray([f"u{u}" for u in users])
        data["item_id"] = np.asarray([f"i{i}" for i in items])
    return data


def _new(n=200, n_users=80, n_items=90, seed=1, ids="int"):
    """New interactions: known and unseen users and items mixed; an item
    past the base catalog carries new categories."""
    r = np.random.default_rng(seed)
    users, items = r.integers(0, n_users, n), r.integers(0, n_items, n)
    cats = np.asarray([_cats([i], new=i >= 60)[0] for i in items], dtype=object)
    data = {"user_id": users * 10 + 3, "item_id": items * 10 + 3, "cat": cats}
    if ids == "str":
        data["user_id"] = np.asarray([f"u{u}" for u in users])
        data["item_id"] = np.asarray([f"i{i}" for i in items])
    return data


def _assert_same_store(t, j):
    """Every field of the port's store bit for bit against the JAX one's."""
    assert t.schema.to_dict() == j.schema.to_dict()
    assert t.schema.to_json() == j.schema.to_json()
    for enc in ("user_encoder", "item_encoder"):
        tl, jl = getattr(t, enc).to_list(), getattr(j, enc).to_list()
        assert tl == jl and [type(v) for v in tl] == [type(v) for v in jl], enc
    for name in ("train_users", "train_items", "test_users", "test_items", "train_neg_items",
                 "test_neg_items"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    tm, jm = t.metadata, j.metadata
    assert tm.names == jm.names
    assert np.array_equal(tm.ids, jm.ids) and np.array_equal(tm.mask, jm.mask)
    assert [e.to_list() for e in tm.encoders] == [e.to_list() for e in jm.encoders]
    assert (t.history_override is None) == (j.history_override is None)
    if t.history_override is not None:
        for a, b in zip(t.history_override, j.history_override):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["int", "str", "meta", "dynamic", "split"])
def test_extend_store_matches_jax(case):
    ids = "str" if case == "str" else "int"
    meta = case == "meta"
    base, new = _base(ids=ids), _new(ids=ids)
    if not meta:
        base, new = ({k: d[k] for k in ("user_id", "item_id")} for d in (base, new))
    kw = dict(metadata_id_col=["cat"] if meta else None, dynamic_neg_sampling=case == "dynamic")
    t = prepare_data(base, "user_id", "item_id", seed=42, **kw)
    j = jprepare(base, "user_id", "item_id", seed=42, **kw)
    _assert_same_store(t, j)
    ext = dict(split_ratio=0.5 if case == "split" else 0.8, dynamic_neg_sampling=case == "dynamic", seed=43)
    te = extend_store(t, new, "user_id", "item_id", **ext)
    je = jextend(j, new, "user_id", "item_id", **ext)
    _assert_same_store(te, je)
    assert te.token != t.token  # the trainer's caches of the old store rebuild
    assert te.schema.num_users > t.schema.num_users and te.schema.num_items > t.schema.num_items
    if meta:  # unseen categories grew the vocabulary; known items kept their rows
        assert te.schema.metadata_vocab_sizes[0] > t.schema.metadata_vocab_sizes[0]
        n = t.schema.num_items
        assert np.array_equal(te.metadata.ids[:n], t.metadata.ids)
        assert np.array_equal(te.metadata.mask[:n], t.metadata.mask)


def test_extend_store_clips_lists_at_the_width():
    base = {"user_id": np.arange(4), "item_id": np.arange(4),
            "cat": np.asarray([[1], [2], [1], [3]], dtype=object)}
    new = {"user_id": np.asarray([0, 9]), "item_id": np.asarray([2, 7]),
           "cat": np.asarray([[5, 6], [7, 8, 9]], dtype=object)}
    t = prepare_data(base, "user_id", "item_id", metadata_id_col=["cat"])
    j = jprepare(base, "user_id", "item_id", metadata_id_col=["cat"])
    te = extend_store(t, new, "user_id", "item_id")
    _assert_same_store(te, jextend(j, new, "user_id", "item_id"))
    row = te.item_encoder.encode_one(7)
    assert te.metadata.width == 1 and te.metadata.mask[row].sum() == 1
    with pytest.raises(ValueError, match="missing metadata"):
        extend_store(t, {"user_id": [1], "item_id": [2]}, "user_id", "item_id")


@pytest.mark.parametrize("length", [1, 4, 16])
def test_user_history_and_history_merge_match_jax(length):
    """user_history at three window lengths, then extend_store of a store
    carrying a checkpointed window (tests/test_data.py:205-241): the
    merged windows equal JAX's."""
    base, new = _base(n=150), _new(n=60)
    base = {k: base[k] for k in ("user_id", "item_id")}
    new = {k: new[k] for k in ("user_id", "item_id")}
    t = prepare_data(base, "user_id", "item_id", split_ratio=0.9)
    j = jprepare(base, "user_id", "item_id", split_ratio=0.9)
    for a, b in zip(t.user_history(length), j.user_history(length)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    o_ids, o_mask = j.user_history(length)
    t.history_override = (o_ids.copy(), o_mask.copy())
    j.history_override = (o_ids.copy(), o_mask.copy())
    te = extend_store(t, new, "user_id", "item_id", seed=7)
    je = jextend(j, new, "user_id", "item_id", seed=7)
    _assert_same_store(te, je)
    assert te.user_history(length)[0] is te.history_override[0]


def test_two_update_data_calls_match_jax():
    """Each update_data call takes the split seed seed + 43 + n_updates."""
    base = _base()
    kw = dict(n_factors=8, metadata_id_col=["cat"], seed=5)
    t = RecSys(base, device="cpu", **kw)
    j = JRecSys(base, **kw)
    for seed in (1, 2):
        t.update_data(_new(seed=seed))
        j.update_data(_new(seed=seed))
        _assert_same_store(t.store, j.store)
    assert t._n_updates == j._n_updates == 2


def test_frozen_encoder_raises_on_unseen_ids():
    enc = IdEncoder.from_list([5, 7]).freeze()
    assert enc.frozen
    np.testing.assert_array_equal(enc.encode([7, 5, 7]), [1, 0, 1])
    with pytest.raises(KeyError, match="frozen"):
        enc.encode([5, 9])
    assert enc.to_list() == [5, 7] and 9 not in enc
    enc.thaw()
    np.testing.assert_array_equal(enc.encode([9, 5]), [2, 0])
    assert not enc.frozen and enc.decode_one(2) == 9


# ---------------------------------------------------------------------------
# grow_state
# ---------------------------------------------------------------------------


def _mcfg(net):
    if net == "mlp":
        return dict(net_type="mlp", n_factors=8, hidden_layers=HIDDEN, use_batch_norm=True)
    return dict(n_factors=8)


def _state_np(js):
    return {k: jax.tree.map(np.asarray, js[k])
            for k in ("tables", "emb_opt", "dense", "model_state", "dense_opt", "step")}


@pytest.mark.parametrize("net", ["linear", "mlp"])
def test_grow_state_matches_jax(net):
    base, new = _base(), _new()
    jstore = jprepare(base, "user_id", "item_id", metadata_id_col=["cat"])
    tstore = prepare_data(base, "user_id", "item_id", metadata_id_col=["cat"])
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**_mcfg(net))),
                  JTrainConfig(batch_size=128, learning_rate=0.05, seed=3))
    js = jt.init_state(jax.random.PRNGKey(0))
    js, _ = jt._epoch_jit(js, jt._device_train_data(jstore), jt.feature_tables(jstore))
    tmodel = build_model(tstore.schema, ModelConfig(**_mcfg(net)))
    ts = train_state_from_jax(_state_np(js), tmodel, "cpu")
    je = jextend(jstore, new, "user_id", "item_id")
    te = extend_store(tstore, new, "user_id", "item_id")
    jg = jgrow(js, jbuild(je.schema, JModelConfig(**_mcfg(net))), jax.random.PRNGKey(4))
    tnew = build_model(te.schema, ModelConfig(**_mcfg(net)))
    tg = grow_state(ts, tnew, torch.Generator().manual_seed(4))
    fresh, _ = tnew.init(torch.Generator().manual_seed(4))
    kept = 0
    for name, t in tg["tables"].items():
        old, acc_old = ts["tables"][name], ts["emb_opt"][name]["acc"]
        n = old.shape[0]
        assert torch.equal(t[:n], old), name  # trained rows bitwise
        assert torch.equal(t[n:], fresh["tables"][name][n:]), name  # the port's fresh draw
        acc = tg["emb_opt"][name]["acc"]
        assert torch.equal(acc[:n], acc_old) and not acc[n:].any(), name
        substituted = t.clone()
        substituted[n:] = torch.from_numpy(np.array(jg["tables"][name])[n:])
        assert np.array_equal(substituted.numpy(), np.asarray(jg["tables"][name])), name
        assert np.array_equal(acc.numpy(), np.asarray(jg["emb_opt"][name]["acc"])), name
        if t.shape == old.shape:  # growth absorbed by the row padding
            assert t is old and acc is acc_old
            kept += 1
    assert kept >= 1 and any(t.shape[0] > ts["tables"][k].shape[0] for k, t in tg["tables"].items())
    for key in ("dense", "model_state", "dense_opt", "step", "rng"):
        assert tg[key] is ts[key], key


@pytest.mark.parametrize("net", ["linear", "mlp"])
def test_update_data_epoch_matches_jax(net):
    """JAX's RecSys fits an epoch, takes new interactions (update_data) and
    trains one more epoch; the port's RecSys grows its store by the same
    interactions, takes JAX's grown state and trains that epoch from it
    with JAX's round keys on the store's static negatives."""
    base, new = _base(), _new()
    kw = dict(n_factors=8, metadata_id_col=["cat"], seed=3, **(
        dict(net_type="mlp", hidden_layers=HIDDEN) if net == "mlp" else {}))
    fit_kw = dict(epochs=1, batch_size=128, learning_rate=0.05, verbose=False)
    j = JRecSys(base, **kw)
    j.fit(**fit_kw)
    j.update_data(new)
    t = RecSys(base, device="cpu", **kw)
    t.update_data(new)
    _assert_same_store(t.store, j.store)
    st = _state_np(j.state)
    t.load_jax_tables(st["tables"], st["emb_opt"], dense=st["dense"], model_state=st["model_state"])
    t.state["dense_opt"] = dense_opt_from_jax(st["dense_opt"], "adam", t.state["dense"], "cpu")
    t.state["step"] = int(st["step"])
    jt = j.trainer
    keys = _round_keys(j.state["rng"])
    js, jloss = jt._epoch_jit(j.state, jt._device_train_data(j.store), jt.feature_tables(j.store))
    tt = Trainer(t.model, TrainConfig(batch_size=128, learning_rate=0.05, seed=3), "cpu")
    ts, tloss = tt.train_epoch(t.state, tt._device_train_data(t.store), tt.feature_tables(t.store),
                               keys=keys)
    rtol = 2e-4 if net == "mlp" else 1e-5
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol, atol=1e-6)
    for name, a in ts["tables"].items():
        np.testing.assert_allclose(a.numpy(), np.asarray(js["tables"][name]), rtol=rtol, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(ts["emb_opt"][name]["acc"].numpy(), np.asarray(js["emb_opt"][name]["acc"]),
                                   rtol=rtol, atol=1e-6, err_msg=name)
    if net == "mlp":  # the weights and the batch-norm variances. A bias's gradient is 0
        # up to rounding where batch norm or neg - pos removes it, and adam turns
        # that rounding into steps of up to lr (tests/test_torch_mlp.py:225-230);
        # the running means follow those biases.
        for what in ("model_state", "dense"):
            for (pa, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ts[what])[0],
                                       jax.tree_util.tree_flatten_with_path(js[what])[0]):
                if pa[-1].key in ("b", "mean"):
                    continue
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=1e-6, err_msg=str(pa))


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_update_data_keeps_old_scores_and_partial_fit_serves_new_users():
    base = _base()
    rs = RecSys(base, n_factors=8, metadata_id_col=["cat"], device="cpu")
    rs.fit(epochs=1, batch_size=128, verbose=False)
    old_users = rs.store.user_encoder.to_list()[:6]
    n_items = rs.store.schema.num_items
    uv, uc = rs.user_vectors(old_users)
    iv, ib = rs.item_vectors()
    rs.update_data(_new())
    uv2, uc2 = rs.user_vectors(old_users)
    iv2, ib2 = rs.item_vectors()
    assert iv2.shape[0] == rs.store.schema.num_items > n_items
    np.testing.assert_array_equal(uv2, uv)
    np.testing.assert_array_equal(uc2, uc)
    np.testing.assert_array_equal(iv2[:n_items], iv)
    np.testing.assert_array_equal(ib2[:n_items], ib)
    new2 = _new(seed=7, n_users=120)
    fresh_user = int(new2["user_id"][new2["user_id"] >= 803][0])
    assert fresh_user not in rs.store.user_encoder
    losses = rs.partial_fit(new2, epochs=1, batch_size=128, verbose=False)
    assert len(losses) == 1 and np.isfinite(losses[0])
    got = rs.predict(fresh_user, top_k=5)
    assert got.shape == (5,)
    assert all(x in rs.store.item_encoder for x in got.tolist())


def test_update_data_drops_the_serving_caches():
    """predict(exclude_seen=True) after update_data excludes the new train
    items, and item_vectors covers the grown catalog: the by-user seen
    index, the raw-id vocabulary and the catalog of the old store go."""
    base = _base()
    rs = RecSys(base, n_factors=8, metadata_id_col=["cat"], device="cpu")
    rs.fit(epochs=1, batch_size=128, verbose=False)
    user = int(base["user_id"][0])
    rs.predict([user], top_k=3, exclude_seen=True)  # builds the seen index
    rs.item_vectors()  # and the catalog
    new_items = np.arange(60, 90) * 10 + 3
    rs.update_data({"user_id": np.full(30, user), "item_id": new_items,
                    "cat": _cats(np.arange(60, 90), new=True)}, split_ratio=1.0)
    row = rs.store.user_encoder.encode_one(user)
    seen = set(rs.store.train_items[rs.store.train_users == row].tolist())
    assert {rs.store.item_encoder.encode_one(int(i)) for i in new_items} <= seen
    n = rs.store.schema.num_items
    got = rs.predict([user], top_k=n - len(seen), exclude_seen=True, return_raw_ids=False)
    assert not set(got[0].tolist()) & seen
    raw = rs.predict([user], top_k=n, return_raw_ids=True)
    assert set(raw[0].tolist()) == set(rs.store.item_encoder.to_list())
    assert rs.item_vectors()[0].shape[0] == n


def test_cold_load_update_data_fit_keeps_dataset_columns(tmp_path):
    """A cold-loaded model remembers its column names and split ratio,
    thaws its encoders for update_data and freezes them again, and trains
    on under the saved train config (tests/test_api.py:484-615)."""
    r = np.random.default_rng(0)
    data = {"u": r.integers(0, 60, 2000), "i": r.integers(0, 40, 2000)}
    m = RecSys(data, "u", "i", n_factors=8, dynamic_neg_sampling=True, split_ratio=0.7, device="cpu")
    m.fit(epochs=1, batch_size=256, loss="warp", num_negatives=4, neg_sampling="popularity",
          verbose=False)
    d = str(tmp_path / "ck")
    m.save(d)
    cold = RecSys.load(d, device="cpu")
    assert (cold._user_col, cold._item_col, cold._split_ratio) == ("u", "i", 0.7)
    assert cold.store.user_encoder.frozen and cold.store.item_encoder.frozen
    more = {"u": r.integers(0, 80, 500), "i": r.integers(0, 50, 500)}
    losses = cold.partial_fit(more, epochs=1, batch_size=256, loss="warp", num_negatives=4,
                              neg_sampling="popularity", verbose=False)
    assert np.isfinite(losses).all()
    assert cold.store.user_encoder.frozen and cold.store.item_encoder.frozen  # frozen again
    assert all(int(u) in cold.store.user_encoder for u in more["u"])
    assert cold.store.schema.num_users == len(set(data["u"].tolist()) | set(more["u"].tolist()))
    assert cold.trainer.cfg.loss == "warp" and cold.trainer.cfg.num_negatives == 4
    assert cold._n_updates == 1 and cold.store.num_train == round(500 * 0.7)
    assert cold.predict(int(more["u"][0]), top_k=4).shape == (4,)

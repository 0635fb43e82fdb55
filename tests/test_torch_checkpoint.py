"""Checkpoints in the port (utils/checkpoint.py, RecSys.save / restore /
load, utils/convert.py::checkpoint_from_jax, debug=True's write_data).

On the CPU, at small sizes: a save and a restore give the state back bit
for bit; a cold load serves the same ids; a resumed fit equals an
uninterrupted one bit for bit (the generator travels with the state); the
sidecars (``schema.json``, ``aux.pkl``) and ``write_data``'s files equal
the JAX package's for the same dataset; a checkpoint the JAX package wrote
reaches the port through ``checkpoint_from_jax`` and predicts JAX's ids.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.utils.checkpoint import load_aux as jload_aux
from torchrecsys_tpu.utils.checkpoint import pack_store_aux as jpack_store_aux
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.train.trainer import derived_generator
from torchrecsys_tpu_torch.utils.checkpoint import load_aux, restore_checkpoint, save_checkpoint
from torchrecsys_tpu_torch.utils.convert import JAX_ONLY_FIELDS, checkpoint_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (32, 16)


def _data(n=800, n_users=50, n_items=60, seed=0, ids="int"):
    r = np.random.default_rng(seed)
    users, items = r.integers(0, n_users, n), r.integers(0, n_items, n)
    data = {
        "user_id": users * 10 + 3,
        "item_id": items * 10 + 3,
        "cat": np.asarray([[int(i % 5)] + ([int(i % 3) + 5] if i % 2 else []) for i in items],
                          dtype=object),
    }
    if ids == "str":
        data["user_id"] = np.asarray([f"u{u}" for u in users])
        data["item_id"] = np.asarray([f"i{i}" for i in items])
    return data


def _leaves(tree, path=""):
    """(path, leaf) pairs of a state: tensors, ints, None, generators."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _leaves(t, f"{path}/{i}")]
    return [(path, tree)]


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), path
        else:
            assert x == y, path


MLP_KW = dict(net_type="mlp", hidden_layers=HIDDEN, use_batch_norm=True)


def test_save_restore_round_trip_is_bitwise(tmp_path):
    """An MLP with batch norm and adam: tables, accumulators, dense weights,
    batch-norm statistics, adam's state and count, the step and the
    generator come back bit for bit in a fresh RecSys, which predicts the
    same ids."""
    data = _data()
    kw = dict(n_factors=8, metadata_id_col=["cat"], device="cpu", **MLP_KW)
    rs = RecSys(data, **kw)
    rs.fit(epochs=1, batch_size=128, learning_rate=0.05, verbose=False)
    d = str(tmp_path / "ck")
    rs.save(d)
    assert sorted(os.listdir(d)) == ["aux.pkl", "schema.json", "state.pt"]
    fresh = RecSys(data, **kw)
    fresh.restore(d)
    _assert_same_state(fresh.state, rs.state)
    assert fresh.state["dense_opt"]["count"] == rs.state["step"] > 0
    users = rs.store.user_encoder.to_list()[:8]
    np.testing.assert_array_equal(fresh.predict(users, top_k=5), rs.predict(users, top_k=5))


@pytest.mark.parametrize("ids", ["int", "str"])
def test_cold_load_serves_the_same_ids(tmp_path, ids):
    data = _data(ids=ids)
    rs = RecSys(data, n_factors=8, metadata_id_col=["cat"], device="cpu")
    rs.fit(epochs=1, batch_size=128, verbose=False)
    d = str(tmp_path / "ck")
    rs.save(d)
    cold = RecSys.load(d, device="cpu")
    assert cold.config == rs.config
    assert cold.store.num_train == 0 and cold.store.user_encoder.frozen
    users = rs.store.user_encoder.to_list()[:10]
    for k in (3, 60):
        np.testing.assert_array_equal(cold.predict(users, top_k=k), rs.predict(users, top_k=k))
    iv, ib = cold.item_vectors()
    np.testing.assert_array_equal(iv, rs.item_vectors()[0])
    with pytest.raises(ValueError, match="exclude_seen"):
        cold.predict(users, top_k=3, exclude_seen=True)


CHILD = """
import sys
import numpy as np
from torchrecsys_tpu_torch import RecSys
cold = RecSys.load(sys.argv[1], device="cpu")
users = cold.store.user_encoder.to_list()[:8]
np.save(sys.argv[2], cold.predict(users, top_k=6))
"""


def test_cold_load_in_a_fresh_process(tmp_path):
    """An MLP with batch norm and adam, loaded by another Python process
    that has neither the dataset nor JAX: the same predict."""
    data = _data()
    rs = RecSys(data, n_factors=8, device="cpu", **MLP_KW)
    rs.fit(epochs=1, batch_size=128, learning_rate=0.05, verbose=False)
    d, out = str(tmp_path / "ck"), str(tmp_path / "ids.npy")
    rs.save(d)
    r = subprocess.run([sys.executable, "-c", CHILD, d, out], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    users = rs.store.user_encoder.to_list()[:8]
    np.testing.assert_array_equal(np.load(out), rs.predict(users, top_k=6))


RESUME = {
    "linear_meta": (dict(metadata_id_col=["cat"]), dict()),
    "mlp_adam": (MLP_KW, dict(learning_rate=0.05)),
    "popularity_cosine": (dict(metadata_id_col=["cat"], dynamic_neg_sampling=True),
                          dict(neg_sampling="popularity", lr_schedule={"kind": "cosine", "decay_steps": 12})),
    "sampled_softmax": (dict(metadata_id_col=["cat"]), dict(loss="sampled_softmax", batch_size=64)),
}


@pytest.mark.parametrize("case", list(RESUME))
def test_resume_is_bit_exact(tmp_path, case):
    """fit(2) equals fit(1) + save + fit(1) from the checkpoint: restored
    into a fresh RecSys on the same data, and loaded cold (its trainer,
    rebuilt from the saved config, fed the same store)."""
    ctor, fit = RESUME[case]
    data = _data()
    kw = dict(n_factors=8, device="cpu", **ctor)
    fit = dict(dict(batch_size=128, verbose=False), **fit)
    whole = RecSys(data, **kw)
    losses = whole.fit(epochs=2, **fit)
    half = RecSys(data, **kw)
    first = half.fit(epochs=1, **fit)
    d = str(tmp_path / "ck")
    half.save(d)
    restored = RecSys(data, **kw)
    restored.restore(d)
    second = restored.fit(epochs=1, **fit)
    assert first + second == losses
    _assert_same_state(restored.state, whole.state)
    cold = RecSys.load(d, device="cpu")
    assert cold.trainer.cfg == half.trainer.cfg
    state, again = cold.trainer.fit(cold.state, half.store, epochs=1, verbose=False)
    assert again == second
    _assert_same_state(state, whole.state)


def test_states_not_made_by_fit_save_and_load(tmp_path):
    """Tables installed by init_tables (no dense optimizer state, no
    generator, no train config) save and load."""
    rs = RecSys(_data(), n_factors=8, device="cpu", seed=4)
    rs.init_tables()
    d = str(tmp_path / "ck")
    rs.save(d)
    assert load_aux(d)["train_cfg"] is None
    cold = RecSys.load(d, device="cpu")
    assert cold.state["dense_opt"] is None and cold.state.get("rng") is None
    _assert_same_state(cold.state["tables"], rs.state["tables"])
    users = rs.store.user_encoder.to_list()[:4]
    np.testing.assert_array_equal(cold.predict(users, top_k=5), rs.predict(users, top_k=5))


def test_a_checkpoint_of_another_dataset_raises(tmp_path):
    rs = RecSys(_data(), n_factors=8, device="cpu")
    rs.fit(epochs=1, batch_size=128, verbose=False)
    d = str(tmp_path / "ck")
    rs.save(d)
    other = RecSys(_data(n_items=200), n_factors=8, device="cpu")
    with pytest.raises(ValueError, match=r"checkpoint tables\['item'\]"):
        other.restore(d)
    wider = RecSys(_data(), n_factors=16, device="cpu")
    with pytest.raises(ValueError, match="checkpoint tables"):
        wider.restore(d)
    os.remove(os.path.join(d, "aux.pkl"))
    with pytest.raises(FileNotFoundError, match="aux.pkl"):
        RecSys.load(d, device="cpu")


def test_generator_comes_back_on_its_device_type_else_derives_from_seed_and_step(tmp_path):
    """A generator saved on the CPU restores exactly; one saved on the card
    (a hand-made state: its ``device`` says cuda) restores on the CPU as
    the generator derived from (seed, step)."""
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    target = {"tables": {"t": torch.empty((2, 3), device="meta")}, "step": 0}
    state = {"tables": {"t": torch.ones((2, 3))}, "step": 7, "rng": gen}
    d = str(tmp_path / "ck")
    save_checkpoint(d, state)
    got = restore_checkpoint(d, target, "cpu", seed=3)
    assert torch.equal(got["rng"].get_state(), gen.get_state()) and got["step"] == 7
    saved = torch.load(os.path.join(d, "state.pt"), weights_only=True)
    saved["rng"]["device"] = "cuda"
    torch.save(saved, os.path.join(d, "state.pt"))
    got = restore_checkpoint(d, target, "cpu", seed=3)
    assert got["rng"].device.type == "cpu"
    assert torch.equal(got["rng"].get_state(), derived_generator("cpu", 3, 7).get_state())
    assert not torch.equal(got["rng"].get_state(), gen.get_state())


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


# the port's config fields with no JAX counterpart: HSTU's shape (models/hstu.py)
PORT_ONLY_FIELDS = {"model_cfg": ("hstu_blocks", "hstu_heads"), "train_cfg": ()}


def _shared(port_cfg: dict, jax_cfg: dict, port_only=()) -> None:
    """Every field of the port's config equals JAX's, but the port's own
    fields, which JAX lacks."""
    assert set(port_cfg) - set(jax_cfg) == set(port_only)
    for k, v in port_cfg.items():
        if k not in port_only:
            assert jax_cfg[k] == v, k


def test_aux_and_schema_match_jax(tmp_path):
    """aux.pkl: JAX's pack_store_aux for the same dataset and configs plus
    dataset_cols, on the config fields both packages have; schema.json
    byte-equal."""
    data = _data(ids="str")
    data["u"], data["i"] = data.pop("user_id"), data.pop("item_id")
    kw = dict(n_factors=8, metadata_id_col=["cat"], split_ratio=0.7, seed=2)
    rs = RecSys(data, "u", "i", device="cpu", **kw)
    rs.fit(epochs=1, batch_size=128, loss="bpr", verbose=False)
    d = str(tmp_path / "ck")
    rs.save(d)
    j = JRecSys(data, "u", "i", **kw)
    jcfg = JTrainConfig(**{f.name: getattr(rs.trainer.cfg, f.name) for f in dataclasses.fields(TrainConfig)})
    want = jpack_store_aux(j.store, j.model_cfg, jcfg)
    got = load_aux(d)
    assert set(got) == set(want) | {"dataset_cols"}
    assert got["dataset_cols"] == {"user": "u", "item": "i", "split_ratio": 0.7, "n_updates": 0}
    assert got["user_vocab"] == want["user_vocab"] and got["item_vocab"] == want["item_vocab"]
    for k in ("ids", "mask"):
        assert np.array_equal(got["metadata"][k], want["metadata"][k])
    assert got["metadata"]["names"] == want["metadata"]["names"]
    assert got["metadata"]["vocabs"] == want["metadata"]["vocabs"]
    _shared(got["model_cfg"], want["model_cfg"], PORT_ONLY_FIELDS["model_cfg"])
    _shared(got["train_cfg"], want["train_cfg"], PORT_ONLY_FIELDS["train_cfg"])
    assert set(want["model_cfg"]) - set(got["model_cfg"]) == set(JAX_ONLY_FIELDS["model_cfg"])
    assert set(want["train_cfg"]) - set(got["train_cfg"]) == set(JAX_ONLY_FIELDS["train_cfg"])
    with open(os.path.join(d, "schema.json"), "rb") as f:
        assert f.read() == j.store.schema.to_json().encode()


def test_a_jax_checkpoint_carried_across(tmp_path):
    """JAX fit -> save -> JAX RecSys.load; its state, aux.pkl and
    schema.json through checkpoint_from_jax -> the port's RecSys.load: the
    same tables and accumulators, the same predict ids, and a fit goes on."""
    data = _data()
    j = JRecSys(data, n_factors=8, metadata_id_col=["cat"], seed=1)
    j.fit(epochs=1, batch_size=128, verbose=False)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    j.save(jd)
    jcold = JRecSys.load(jd)
    with open(os.path.join(jd, "schema.json")) as f:
        schema = json.load(f)
    checkpoint_from_jax(pd, jax.tree.map(np.asarray, dict(jcold.state)), jload_aux(jd), schema)
    cold = RecSys.load(pd, device="cpu")
    for name, t in cold.state["tables"].items():
        assert np.array_equal(t.numpy(), np.asarray(jcold.state["tables"][name])), name
        assert np.array_equal(cold.state["emb_opt"][name]["acc"].numpy(),
                              np.asarray(jcold.state["emb_opt"][name]["acc"])), name
    assert cold.state["step"] == int(jcold.state["step"]) and cold.state["rng"] is None
    assert cold.model_cfg == ModelConfig(n_factors=8) and cold.seed == 1
    users = jcold.store.user_encoder.to_list()[:10]
    np.testing.assert_array_equal(cold.predict(users, top_k=5), jcold.predict(users, top_k=5))
    with open(os.path.join(pd, "aux.pkl"), "rb") as f:
        aux = pickle.load(f)
    assert not set(aux["model_cfg"]) & set(JAX_ONLY_FIELDS["model_cfg"])
    cold.update_data({"user_id": np.asarray([3, 13, 999]), "item_id": np.asarray([3, 13, 23]),
                      "cat": np.asarray([[1], [2], [3]], dtype=object)}, split_ratio=1.0)
    assert np.isfinite(cold.fit(epochs=1, batch_size=128, verbose=False)).all()


def test_debug_writes_config_and_meta_like_jax(tmp_path):
    data = _data()
    tp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    RecSys(data, n_factors=8, metadata_id_col=["cat"], debug=True, path=tp, device="cpu")
    JRecSys(data, n_factors=8, metadata_id_col=["cat"], debug=True, path=jp)
    for name in ("config.json", "meta.csv"):
        with open(os.path.join(tp, name), "rb") as a, open(os.path.join(jp, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(tp, "meta.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "item_row,raw_item_id,cat" and len(lines) == 61
    assert any(line.endswith(']"') and ", " in line for line in lines[1:])  # two-id lists

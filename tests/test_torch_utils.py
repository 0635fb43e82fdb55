"""The port's utilities and public-surface pieces against the JAX package's.

- Logging (utils/logging.py): ``get_logger``'s handler, formatter, level
  and propagation; ``fit(verbose=True)`` and ``evaluate(verbose=True)``
  emit JAX's records (the same count and message shape, the logged losses
  within the epoch tolerance of tests/test_torch_train.py: rtol=1e-5,
  atol=1e-6), on stdout with the ``[name]`` prefix; ``verbose=False``
  emits none; the streamed fit logs its epoch line.
- Profiling (utils/profiling.py, utils/trace_files.py): ``trace``,
  ``annotate`` and ``op_summary`` on the CPU, the digest of a synthetic
  card trace (kernels summed by name, the lead-in set aside), and
  ``profile_epochs`` through ``Trainer.fit``: the digest logged once, the
  losses and tables of the profiled fit equal the unprofiled fit's bit for
  bit and JAX's profiled fit's within the epoch tolerance.
- ``InteractionStore.batches``, ``Trainer.train_step`` (Linear hinge with
  static negatives, FM with metadata, the BN MLP: one step against JAX's
  ``train_step`` within the step tolerances of tests/test_torch_train.py
  and tests/test_torch_mlp.py), ``full_catalog_scores`` (Linear, FM with
  metadata, the MLP, the LSTM, within 1e-5), ``IdEncoder.from_values``,
  ``MetadataTable.gather`` and ``DataSchema.num_metadata_features``.

Both packages start from the same tables (the JAX trainer's init carried
over) and train on the store's static negatives; each epoch's Feistel round
keys are the ones the JAX trainer derives, handed to the port.
"""

import gzip
import json
import logging
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.data.encoder import IdEncoder as JIdEncoder
from torchrecsys_tpu.eval import predict as jpred
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.utils import logging as jlogging
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.data.encoder import IdEncoder
from torchrecsys_tpu_torch.eval import predict as tpred
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train import trainer as trainer_mod
from torchrecsys_tpu_torch.utils import logging as tlogging
from torchrecsys_tpu_torch.utils import profiling, trace_files
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests.test_torch_lstm import carried, seq_pair
from tests.test_torch_mlp import _assert_trees, _one_batch, _state_np
from tests.test_torch_train import _data, _round_keys

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_train.py's epoch and step tolerance
SEED = 3
EPOCH_RE = re.compile(r"^epoch \d+: loss=\d+\.\d{5} \(\d+\.\d{2}s\)$")
EVAL_RE = re.compile(r"^eval: loss=\d+\.\d{5} auc=\d+\.\d{5}$")
STREAM_RE = re.compile(r"^epoch \d+: loss=\d+\.\d{5} \(\d+\.\d{2}s, \d+ super-batches\)$")


class _Records(logging.Handler):
    """Every record reaching the two packages' root loggers (which do not
    propagate to the stdlib root)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def of(self, pkg, prefix=""):
        return [r for r in self.records
                if r.name.split(".")[0] == pkg and r.getMessage().startswith(prefix)]


@pytest.fixture
def records():
    h = _Records()
    roots = [logging.getLogger(n) for n in ("torchrecsys_tpu", "torchrecsys_tpu_torch")]
    for r in roots:
        r.addHandler(h)
    try:
        yield h
    finally:
        for r in roots:
            r.removeHandler(h)


def _jax_keys(epochs):
    """The round keys JAX's epochs draw from ``PRNGKey(seed)`` (the state's
    generator splits once per epoch, trainer.py:617)."""
    rng, out = jax.random.PRNGKey(SEED), []
    for _ in range(epochs):
        out.append(_round_keys(rng))
        rng = jax.random.split(rng)[0]
    return out


@pytest.fixture
def jax_keys(monkeypatch):
    """The port's ``round_keys`` replaced by JAX's keys, epoch by epoch."""
    keys = iter(_jax_keys(4))
    monkeypatch.setattr(trainer_mod, "round_keys", lambda gen: next(keys))


# ---------------------------------------------------------------------------
# logging (C2)
# ---------------------------------------------------------------------------


def test_get_logger_configures_the_package_root_like_jax():
    jlogging.get_logger("torchrecsys_tpu.x")
    log = tlogging.get_logger("torchrecsys_tpu_torch.x")
    assert log.name == "torchrecsys_tpu_torch.x"
    jroot, troot = logging.getLogger("torchrecsys_tpu"), logging.getLogger("torchrecsys_tpu_torch")
    assert len(troot.handlers) == len(jroot.handlers) == 1
    jh, th = jroot.handlers[0], troot.handlers[0]
    assert isinstance(th, logging.StreamHandler) and isinstance(jh, logging.StreamHandler)
    assert th.stream is sys.stdout
    assert th.formatter._fmt == jh.formatter._fmt == "[%(name)s] %(message)s"
    assert troot.level == jroot.level == logging.INFO
    assert troot.propagate is jroot.propagate is False
    tlogging.get_logger()  # a second call adds nothing
    assert len(troot.handlers) == 1
    assert tlogging.get_logger().name == "torchrecsys_tpu_torch"


def _facades():
    """JAX's and the port's RecSys over the same data, both at JAX's init."""
    data = _data(False)
    jrs = JRecSys(data, n_factors=16, seed=SEED, dynamic_neg_sampling=False)
    jt = JTrainer(jbuild(jrs.store.schema, jrs.model_cfg), JTrainConfig(seed=SEED))
    jrs.state = jt.init_state(jax.random.PRNGKey(SEED))
    rs = RecSys(data, n_factors=16, seed=SEED, dynamic_neg_sampling=False, device="cpu")
    st = _state_np(jrs.state)
    rs.load_jax_tables(st["tables"], st["emb_opt"])
    return jrs, rs


def test_verbose_fit_and_evaluate_log_like_jax(records, jax_keys, capsys):
    """C2: the port's epoch and eval records match JAX's in count, shape
    and value, and reach stdout with the ``[name]`` prefix; verbose=False
    logs nothing."""
    jrs, rs = _facades()
    fit_kw = dict(epochs=2, batch_size=128, learning_rate=0.05)
    jlosses = jrs.fit(verbose=True, **fit_kw)
    jrs.evaluate(eval_metrics=("loss", "auc"), verbose=True)
    tlosses = rs.fit(verbose=True, **fit_kw)
    rs.evaluate(eval_metrics=("loss", "auc"), verbose=True)
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL, atol=ATOL)
    for prefix, shape in (("epoch", EPOCH_RE), ("eval", EVAL_RE)):
        got, want = records.of("torchrecsys_tpu_torch", prefix), records.of("torchrecsys_tpu", prefix)
        assert len(got) == len(want) == (2 if prefix == "epoch" else 1)
        for g, w in zip(got, want):
            assert g.name.replace("torchrecsys_tpu_torch", "torchrecsys_tpu") == w.name
            assert g.levelno == w.levelno == logging.INFO
            assert shape.match(g.getMessage()) and shape.match(w.getMessage())
            if prefix == "epoch":
                assert g.args[0] == w.args[0]
            vals = (1,) if prefix == "epoch" else (0, 1)
            np.testing.assert_allclose([g.args[i] for i in vals], [w.args[i] for i in vals],
                                       rtol=RTOL, atol=ATOL)
    out = capsys.readouterr().out
    assert re.search(r"^\[torchrecsys_tpu_torch\.train\] epoch 0: loss=\d", out, re.M)
    assert re.search(r"^\[torchrecsys_tpu_torch\.train\] eval: loss=\d", out, re.M)
    n = len(records.records)
    rs.fit(verbose=False, **fit_kw)
    rs.evaluate(eval_metrics=("loss", "auc"), verbose=False)
    assert len(records.records) == n
    assert "torchrecsys_tpu_torch" not in capsys.readouterr().out


def test_streamed_fit_logs_its_epoch_line(records):
    rs = RecSys(_data(False), n_factors=8, seed=SEED, device="cpu")
    rs.init_tables()
    trainer = Trainer(rs.model, TrainConfig(batch_size=64, seed=SEED), "cpu")
    _, losses = trainer.fit_streaming(rs.state, rs.store, superbatch_size=256, epochs=2)
    got = records.of("torchrecsys_tpu_torch", "epoch")
    assert [r.name for r in got] == ["torchrecsys_tpu_torch.streaming"] * 2
    assert all(STREAM_RE.match(r.getMessage()) for r in got)
    assert [r.args[1] for r in got] == losses
    assert got[0].args[3] == -(-rs.store.num_train // 256)


# ---------------------------------------------------------------------------
# trace, annotate, op_summary
# ---------------------------------------------------------------------------


def test_trace_annotate_and_op_summary_on_the_cpu(tmp_path, records):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("trs_region"):
            (x @ x).relu().sum()
    path = trace_files.latest_trace_file(str(tmp_path / "t"))
    assert path is not None and path.endswith(".pt.trace.json")
    names = {e["name"] for e in trace_files.read_events(path)}
    assert "trs_region" in names and "aten::mm" in names
    table = profiling.op_summary(str(tmp_path / "t"))
    assert "failed to parse" not in table
    lines = table.splitlines()
    assert lines[0] == f"[{trace_files.HOST_LABEL}]"
    assert lines[1].split() == ["op", "total", "avg", "count", "%"]
    assert lines[-1].startswith("TOTAL")
    assert any(line.startswith("aten::mm") for line in lines)
    [rec] = records.of("torchrecsys_tpu_torch", "profiler trace captured")
    assert rec.name == "torchrecsys_tpu_torch.profiling"


def test_op_summary_never_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    assert profiling.op_summary(str(tmp_path / "empty")) == (
        f"(no *.pt.trace.json trace found under {tmp_path / 'empty'})"
    )
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "w.1.pt.trace.json").write_text("{not json")
    assert profiling.op_summary(str(bad)).startswith(f"(failed to parse trace {bad / 'w.1.pt.trace.json'}:")


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur, "args": args}


def test_op_totals_sums_kernels_by_name_without_the_lead_in(tmp_path):
    """A card trace as torch.profiler writes it: kernels summed per device
    and name; the lead-in's kernels (launched inside its annotation) and
    host ops set aside; host ops by self time (a parent less its child)."""
    ev = [
        _event("user_annotation", trace_files.LEAD_IN, 0.0, 10.0),
        _event("cuda_runtime", "cudaLaunchKernel", 2.0, 1.0, correlation=1),
        _event("cpu_op", "aten::fill_", 3.0, 1.0),
        _event("kernel", "spin_kernel(long)", 20.0, 5.0, device=0, correlation=1),
        _event("cpu_op", "aten::add", 11.0, 10.0),
        _event("cpu_op", "aten::empty", 12.0, 4.0),
        _event("cuda_runtime", "cudaLaunchKernel", 17.0, 1.0, correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", 18.0, 1.0, correlation=3),
        _event("cuda_runtime", "cudaLaunchKernel", 19.0, 1.0, correlation=4),
        _event("kernel", "void k<1, true>(Args)", 30.0, 2.5, device=0, correlation=2),
        _event("kernel", "void k<1, true>(Args)", 40.0, 3.5, device=0, correlation=3),
        _event("kernel", "void ns::other(float*)", 50.0, 1.0, device=1, correlation=4),
    ]
    path = tmp_path / "a.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}, f)
    assert trace_files.latest_trace_file(str(tmp_path)) == str(path)
    got = trace_files.op_totals(str(path), include_host=True)
    assert got["/device:cuda:0 / kernels"] == [("void k<1, true>(Args)", 6.0, 2)]
    assert got["/device:cuda:1 / kernels"] == [("void ns::other(float*)", 1.0, 1)]
    assert got[trace_files.HOST_LABEL] == [("aten::add", 6.0, 1), ("aten::empty", 4.0, 1)]
    assert [trace_files.kernel_base_name(n) for n in ("void k<1, true>(Args)", "void ns::other(float*)",
                                                       "void (anonymous namespace)::z<2>(A)")] == ["k", "other", "z"]
    table = trace_files.format_op_table(str(path))
    assert table.startswith("[/device:cuda:0 / kernels]") and "aten::add" not in table
    assert "TOTAL" in table and "6.0us" in table


def _trainer_pair(profile_epochs, mcfg=None):
    data = _data(True)
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    mcfg = mcfg or dict(n_factors=16)
    cfg = dict(batch_size=128, learning_rate=0.05, seed=SEED, profile_epochs=profile_epochs)
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(**cfg))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)), TrainConfig(**cfg), "cpu")
    return jstore, tstore, jt, tt


def test_profile_epochs_changes_no_number(tmp_path, records, monkeypatch):
    """``profile_epochs=1`` through ``Trainer.fit(profile_dir=...)``: one
    trace, the digest logged once, losses and tables equal an unprofiled
    fit's bit for bit and JAX's profiled fit's within the epoch tolerance."""
    jstore, tstore, jt, tt = _trainer_pair(1)
    _, _, _, plain = _trainer_pair(0)
    js = jt.init_state(jax.random.PRNGKey(0))
    runs = {}
    for name, trainer in (("profiled", tt), ("plain", plain)):
        keys = iter(_jax_keys(2))
        monkeypatch.setattr(trainer_mod, "round_keys", lambda gen: next(keys))
        ts = train_state_from_jax(_state_np(js), trainer.model, "cpu")
        runs[name] = trainer.fit(ts, tstore, epochs=2, verbose=False, profile_dir=str(tmp_path / "port"))
    digests = records.of("torchrecsys_tpu_torch", "per-op device time digest:")
    assert len(digests) == 1 and digests[0].name == "torchrecsys_tpu_torch.train"
    assert "TOTAL" in digests[0].getMessage() and "failed to parse" not in digests[0].getMessage()
    assert trace_files.latest_trace_file(str(tmp_path / "port")) is not None
    (st_p, l_p), (st_0, l_0) = runs["profiled"], runs["plain"]
    assert l_p == l_0
    for name in st_0["tables"]:
        assert torch.equal(st_p["tables"][name], st_0["tables"][name]), name
        assert torch.equal(st_p["emb_opt"][name]["acc"], st_0["emb_opt"][name]["acc"]), name
    _, jl = jt.fit(js, jstore, epochs=2, verbose=False, profile_dir=str(tmp_path / "jax"))
    np.testing.assert_allclose(l_p, jl, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the public-surface gaps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split, shuffle, seed, drop", [
    ("train", True, 0, False), ("train", True, 5, True), ("train", False, 0, False), ("test", True, 1, False),
])
def test_batches_match_jax(split, shuffle, seed, drop):
    data = _data(True)
    kw = dict(metadata_id_col=["cat"])
    jst = jprepare(data, "user_id", "item_id", **kw)
    tst = prepare_data(data, "user_id", "item_id", **kw)
    got = list(tst.batches(64, split=split, shuffle=shuffle, seed=seed, drop_remainder=drop))
    want = list(jst.batches(64, split=split, shuffle=shuffle, seed=seed, drop_remainder=drop))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_from_values_gather_and_num_metadata_features_match_jax():
    values = ["b", 7, "a", 7, ("t", 1), "b", 3.5]
    got, want = IdEncoder.from_values(values), JIdEncoder.from_values(values)
    assert got.to_list() == want.to_list() and len(got) == len(want) == 5
    data = _data(True)
    data["tag"] = np.asarray([[int(i % 4)] for i in data["item_id"]], dtype=object)
    kw = dict(metadata_id_col=["cat", "tag"])
    jst = jprepare(data, "user_id", "item_id", **kw)
    tst = prepare_data(data, "user_id", "item_id", **kw)
    assert tst.schema.num_metadata_features == jst.schema.num_metadata_features == 2
    assert prepare_data(_data(False), "user_id", "item_id").schema.num_metadata_features == 0
    rows = np.asarray([0, 5, 3, 5, tst.schema.num_items - 1])
    for g, w in zip(tst.metadata.gather(rows), jst.metadata.gather(rows)):
        np.testing.assert_array_equal(g, np.asarray(w))


def _unique_meta_data(n=3000, n_users=300, n_items=600, seed=0):
    """Items with their own category each: distinct items in a batch touch
    distinct metadata rows, where JAX's unfused train_step and the fused
    update the epoch runs agree."""
    r = np.random.default_rng(seed)
    items = r.integers(0, n_items, n)
    return {"user_id": r.integers(0, n_users, n), "item_id": items,
            "cat": np.asarray([[int(i)] for i in items], dtype=object)}


@pytest.mark.parametrize("net", ["linear", "fm_meta", "mlp"])
def test_train_step_matches_jax(net):
    """One step of each net through ``Trainer.train_step`` from JAX's init
    against JAX's public ``train_step`` (distinct users and items, so the
    fused update equals JAX's unfused one), with the store's static
    negatives and per-row weights: Linear and FM within rtol=1e-5,
    atol=1e-6, the MLP (f32, dense adagrad) within tests/test_torch_mlp.py's
    step tolerance rtol=2e-4, atol=1e-6."""
    meta = net == "fm_meta"
    data = _unique_meta_data() if meta else _data(False, n=3000, n_users=300, n_items=600)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = {"linear": dict(n_factors=8), "fm_meta": dict(net_type="fm", n_factors=8),
            "mlp": dict(net_type="mlp", n_factors=8, hidden_layers=(32, 16), use_batch_norm=True)}[net]
    cfg = dict(batch_size=48, learning_rate=0.05, seed=SEED, dense_optimizer="adagrad")
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(**cfg))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)), TrainConfig(**cfg), "cpu")
    assert tt._fused == (net != "mlp")
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = train_state_from_jax(_state_np(js), tt.model, "cpu", dense_optimizer="adagrad")
    users, pos, neg, w = _one_batch(tstore, 48)
    batch = {"user_id": users, "pos_item_id": pos, "neg_item_id": neg, "_w": w}
    js2, jloss = jax.jit(jt.train_step)(js, {k: jnp.asarray(v) for k, v in batch.items()},
                                        jt.feature_tables(jstore))
    ts2, tloss = tt.train_step(ts, batch, tt.feature_tables(tstore))
    assert ts2["step"] == int(js2["step"]) == 1
    rtol = 2e-4 if net == "mlp" else RTOL
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    _assert_trees(ts2["tables"], js2["tables"], rtol, ATOL, "tables")
    _assert_trees(ts2["emb_opt"], js2["emb_opt"], rtol, ATOL, "emb_opt")
    if net == "mlp":
        _assert_trees(ts2["dense"], js2["dense"], rtol, ATOL, "dense")
        _assert_trees(ts2["model_state"], js2["model_state"], rtol, ATOL, "model_state")


def test_train_step_draws_in_step_negatives_and_applies_the_order():
    """A config that draws in training ignores ``neg_item_id`` (drawn from
    the state's generator); ``_order`` reorders every row first."""
    store = prepare_data(_data(False), "user_id", "item_id", dynamic_neg_sampling=False)
    model = build_model(store.schema, ModelConfig(n_factors=8))
    users, pos, neg, w = _one_batch(store, 16)
    batch = {"user_id": users, "pos_item_id": pos, "neg_item_id": neg}
    pop = Trainer(model, TrainConfig(batch_size=16, neg_sampling="popularity"), "cpu")
    s0 = pop.init_state()
    feat = pop.feature_tables(store)
    a, la = pop.train_step(s0, batch, feat)
    b, lb = pop.train_step(pop.init_state(), dict(batch, neg_item_id=neg[::-1].copy()), feat)
    assert float(la) == float(lb) and torch.equal(a["tables"]["item"], b["tables"]["item"])
    static = Trainer(model, TrainConfig(batch_size=16), "cpu")
    order = np.argsort(users, kind="stable")
    c, lc = static.train_step(static.init_state(), dict(batch, _order=order))
    d, ld = static.train_step(static.init_state(), {k: v[order] for k, v in batch.items()})
    assert float(lc) == float(ld) and torch.equal(c["tables"]["user"], d["tables"]["user"])


@pytest.mark.parametrize("net", ["linear", "fm_meta", "mlp", "lstm"])
def test_full_catalog_scores_match_jax(net):
    if net == "lstm":
        jstore, tstore, jt, tt = seq_pair("lstm")
        js, ts = carried(jt, tt)
    else:
        mcfg = {"linear": dict(n_factors=8), "fm_meta": dict(net_type="fm", n_factors=8),
                "mlp": dict(net_type="mlp", n_factors=8, hidden_layers=(32, 16), use_batch_norm=True)}[net]
        jstore, tstore, jt, tt = _trainer_pair(0, mcfg)
        js = jt.init_state(jax.random.PRNGKey(1))
        ts = train_state_from_jax(_state_np(js), tt.model, "cpu")
    users = np.asarray([0, 3, 7, tstore.schema.num_users - 1])
    n = tstore.schema.num_items
    want = jpred.full_catalog_scores(jt.model, {"tables": js["tables"], "dense": js["dense"]},
                                     js["model_state"], jnp.asarray(users, jnp.int32), n,
                                     jt.feature_tables(jstore))
    got = tpred.full_catalog_scores(tt.model, {"tables": ts["tables"], "dense": ts["dense"]},
                                    ts["model_state"], users, n, tt.feature_tables(tstore))
    assert got.shape == (len(users), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

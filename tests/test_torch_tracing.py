"""The port's spans and counters (utils/profiling.py) and the benchmark's
span arithmetic (perfbench/lib/spans.py and the readers that use it).

- Spans record only under torch.profiler; the counters always count.
- ``predict``: one root a call, its children in order, nested in it and
  sharing its id; ``fit`` -> ``epoch`` -> build / pack / steps (``step`` per
  batch) / unpack, on the fused, the autograd and the softmax step loops.
- Spans change no number: ids and losses bitwise equal with them on and off.
- The counters: the kept catalog, the seen index, the top-k kernels' plan
  and TMA-map caches, nvcc runs, the trainer's uploads and feature tables.
- The span arithmetic and the readers, on hand-made spans and device records
  with known self times and idle overlaps.
- On the card (``gpu``): the spans' clock is the device trace's, a span
  around a kernel and a synchronise encloses the kernel's kineto interval.
  This file imports no JAX: ``python -m pytest --noconftest -m gpu
  tests/test_torch_tracing.py`` runs it where a card is and JAX is not.
"""

import contextlib
import os
import stat
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.lib import spans as lib_spans, spec
from perfbench.lib.trace import DeviceTrace
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.ops import dot_topk as tdt
from torchrecsys_tpu_torch.utils import profiling
from torchrecsys_tpu_torch.utils.profiling import Span

SERVE = ["predict.encode", "predict.user_vectors", "predict.topk", "predict.fetch", "predict.decode"]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.reset()
    yield
    profiling.reset()


def _interactions(seed=0, n=3000):
    r = np.random.default_rng(seed)
    return {"user_id": r.integers(0, 120, n) * 7 + 3, "item_id": r.integers(0, 300, n) * 5 + 1}


def _recsys(seed=0):
    return RecSys(_interactions(seed), device="cpu", n_factors=16, seed=seed)


def _host_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(sp, i):
    return [s for s in sp if s.parent == i]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_no_record_without_a_profiler_while_counters_count():
    before = profiling.counters()
    rs = _recsys()
    rs.fit(batch_size=256, verbose=False)
    users = rs.store.user_encoder.to_list()[:8]
    for _ in range(3):
        rs.predict(users, top_k=5)
    rs.predict(users, top_k=5, exclude_seen=True)
    assert profiling.spans() == []
    after = profiling.counters()
    assert set(after) == set(profiling.COUNTERS)
    assert after["catalog.builds"] == before["catalog.builds"] + 1
    assert after["seen_index.builds"] == before["seen_index.builds"] + 1
    assert after["fit.feature_table_builds"] == before["fit.feature_table_builds"] + 1
    assert after["spans.dropped"] == 0
    with profiling.annotate("outside"):
        pass
    assert profiling.spans() == []


@pytest.mark.parametrize("exclude_seen", [False, True])
def test_predict_records_one_root_a_call_with_its_children_in_order(exclude_seen):
    rs = _recsys()
    rs.fit(batch_size=256, verbose=False)
    users = rs.store.user_encoder.to_list()[:8]
    with _host_profile():
        for _ in range(3):
            rs.predict(users, top_k=5, exclude_seen=exclude_seen)
    sp = profiling.spans()
    roots = [i for i, s in enumerate(sp) if s.parent == -1]
    assert [sp[i].name for i in roots] == ["predict"] * 3
    want = SERVE[:1] + ["predict.seen"] * exclude_seen + SERVE[1:]
    for i in roots:
        kids = _children(sp, i)
        assert [k.name for k in kids] == want
        assert all(k.root == i and sp[i].start_ns <= k.start_ns <= k.end_ns <= sp[i].end_ns for k in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert all(s.root in roots for s in sp)
    assert profiling.counters()["spans.dropped"] == 0


@pytest.mark.parametrize(
    "kw",
    [dict(loss="hinge"), dict(loss="bpr", num_negatives=2), dict(loss="sampled_softmax")],
    ids=["fused", "autograd", "softmax"],
)
def test_fit_records_epochs_of_build_pack_steps_unpack(kw):
    rs = _recsys()
    with _host_profile():
        rs.fit(batch_size=256, epochs=2, verbose=False, **kw)
    sp = profiling.spans()
    [root] = [i for i, s in enumerate(sp) if s.parent == -1]
    assert sp[root].name == "fit"
    top = _children(sp, root)
    assert [s.name for s in top] == ["fit.train_data", "fit.feature_tables", "epoch", "epoch", "fit.losses"]
    nb = -(-rs.store.num_train // 256)
    for e in (i for i, s in enumerate(sp) if s.name == "epoch"):
        assert [s.name for s in _children(sp, e)] == ["epoch.build", "epoch.pack", "epoch.steps", "epoch.unpack"]
        [steps] = [i for i, s in enumerate(sp) if s.parent == e and s.name == "epoch.steps"]
        assert [s.name for s in _children(sp, steps)] == ["step"] * nb
    assert all(s.root == root and s.end_ns >= s.start_ns for s in sp)


def test_spans_change_no_number():
    out = []
    for traced in (False, True):
        rs = _recsys(seed=3)
        users = rs.store.user_encoder.to_list()[:16]
        with _host_profile() if traced else contextlib.nullcontext():
            losses = rs.fit(batch_size=256, epochs=2, verbose=False)
            ids = rs.predict(users, top_k=7)
            seen = rs.predict(users, top_k=7, exclude_seen=True)
        out.append((losses, ids, seen, {k: v.clone() for k, v in rs.state["tables"].items()}))
    (l0, i0, s0, t0), (l1, i1, s1, t1) = out
    assert l0 == l1 and np.array_equal(i0, i1) and np.array_equal(s0, s1)
    assert all(torch.equal(t0[k], t1[k]) for k in t0)
    assert len(profiling.spans()) > 0


def test_spans_past_the_buffer_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _host_profile():
        for name in "abcde":
            with profiling.annotate(name):
                pass
    assert [s.name for s in profiling.spans()] == ["a", "b", "c"]
    assert profiling.counters()["spans.dropped"] == 2
    run = SimpleNamespace(kind="serve", trace=DeviceTrace([], 1.0), requests=1)
    with pytest.raises(RuntimeError, match="2 spans dropped"):
        lib_spans.window_spans(run)
    profiling.reset()
    assert profiling.counters()["spans.dropped"] == 0


def test_annotate_opens_a_profiler_range_with_host_activity():
    with _host_profile() as p:
        with profiling.annotate("trs_span"):
            with profiling.annotate("trs_inner"):
                torch.ones(4).sum()
    names = [e.name() for e in p.profiler.kineto_results.events()]
    assert "trs_span" in names and "trs_inner" in names
    outer, inner = profiling.spans()
    assert (outer.parent, inner.parent, inner.root) == (-1, 0, 0)
    # one clock: the profiler's range of the inner span lies within the outer span
    [ev] = [e for e in p.profiler.kineto_results.events() if e.name() == "trs_inner"]
    assert outer.start_ns <= ev.start_ns() <= ev.end_ns() <= outer.end_ns


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def test_catalog_seen_index_and_trainer_counters():
    rs = _recsys()
    c0 = profiling.counters()
    rs.fit(batch_size=256, verbose=False)
    rs.fit(batch_size=256, verbose=False)
    users = rs.store.user_encoder.to_list()[:4]
    for _ in range(5):
        rs.predict(users, top_k=3)
        rs.predict(users, top_k=3, exclude_seen=True)
    c1 = profiling.counters()
    assert c1["catalog.builds"] - c0["catalog.builds"] == 1
    assert c1["seen_index.builds"] - c0["seen_index.builds"] == 1
    assert c1["fit.feature_table_builds"] - c0["fit.feature_table_builds"] == 2
    assert c1["fit.train_data_uploads"] - c0["fit.train_data_uploads"] == 1  # one trainer, one store
    rs.fit(batch_size=256, verbose=False)
    rs.predict(users, top_k=3)
    c2 = profiling.counters()
    assert c2["catalog.builds"] - c1["catalog.builds"] == 1  # new tables, a new catalog


class _FakeTopkLib:
    def trs_dot_topk_plan(self, *args):
        return 0

    def trs_dot_topk_tensor_map(self, *args):
        return 0


def test_topk_plan_and_tensor_map_misses_are_counted(monkeypatch):
    monkeypatch.setattr(tdt, "_lib", lambda: _FakeTopkLib())
    monkeypatch.setattr(tdt, "_device_index", lambda dev: 0)
    monkeypatch.setattr(tdt, "_PLANS", {})
    monkeypatch.setattr(tdt, "_TENSOR_MAPS", {})
    c0 = profiling.counters()
    for _ in range(3):
        tdt.plan(False, 256, 1000, 80, False, 10)
    tdt.plan(True, 256, 1000, 80, False, 128)
    assert profiling.counters()["dot_topk.plans"] - c0["dot_topk.plans"] == 2
    tables = [torch.zeros(4, 8) for _ in range(tdt._MAX_TENSOR_MAPS + 1)]
    for t in tables:
        tdt._tensor_map(t, 4, 8, False)
        tdt._tensor_map(t, 4, 8, False)
    got = profiling.counters()["dot_topk.tensor_maps"] - c0["dot_topk.tensor_maps"]
    assert got == tdt._MAX_TENSOR_MAPS + 1
    tdt._tensor_map(tables[0], 4, 8, False)  # cleared at 64 entries: a miss again
    assert profiling.counters()["dot_topk.tensor_maps"] - c0["dot_topk.tensor_maps"] == got + 1


def test_kernels_built_counts_nvcc_runs(tmp_path, monkeypatch):
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    (src / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    c0 = profiling.counters()["kernels.built"]
    first = _build.build_all(["k.cu"])
    assert os.path.exists(first["k.cu"].library)
    _build.build_all(["k.cu"])  # built already: no nvcc
    assert profiling.counters()["kernels.built"] - c0 == 1


# ---------------------------------------------------------------------------
# perfbench/lib/spans.py and the readers
# ---------------------------------------------------------------------------

US = 1000


def _serve_spans(requests=2):
    """Two requests of 100 us, each: encode 10, user_vectors 10, topk 20,
    fetch 40, decode 10 (10 us of self time), 50 us of client between."""
    out = []
    for r in range(requests):
        t = r * 150 * US
        root = len(out)
        out.append(Span("predict", t, t + 100 * US, -1, root))
        at = t + 5 * US
        for name, d in zip(SERVE, (10, 10, 20, 40, 10)):
            out.append(Span(name, at, at + d * US, root, root))
            at += d * US
        # 5 us of predict's own time before encode and 5 after decode
    return out


def _serve_device():
    """Busy: request r's top-k 40-85 us after its start; idle otherwise."""
    return [("k", r * 150 * US + 40 * US, r * 150 * US + 85 * US) for r in range(2)]


def test_span_arithmetic_on_hand_made_spans():
    sp = _serve_spans()
    assert lib_spans.self_ns(sp)[0] == 10 * US and lib_spans.self_ns(sp)[1] == 10 * US
    own = lib_spans.self_ms_by_name(sp, "predict")
    assert own["predict"] == pytest.approx(0.010) and own["predict.fetch"] == pytest.approx(0.040)
    assert lib_spans.per_root_ms(sp, "predict", "predict.topk", expect=2) == pytest.approx(0.020)
    with pytest.raises(RuntimeError, match="2 'predict' spans in a window of 3"):
        lib_spans.per_root_ms(sp, "predict", "predict.topk", expect=3)
    with pytest.raises(RuntimeError, match="no 'predict.seen'"):
        lib_spans.per_root_ms(sp, "predict", "predict.seen")
    with pytest.raises(RuntimeError, match="no 'fit'"):
        lib_spans.roots(sp, "fit")
    assert lib_spans.mean_ms(sp, "predict") == pytest.approx(0.100)
    gaps = lib_spans.idle_intervals(_serve_device())
    assert gaps == [(85 * US, 190 * US)]
    pieces = lib_spans.innermost(sp)
    assert pieces[0] == (0, 5 * US, "predict") and pieces[1] == (5 * US, 15 * US, "predict.encode")
    assert sum(b - a for a, b, _ in pieces) == 200 * US
    by = lib_spans.overlap_by_name(gaps, pieces)
    # the gap 85-190 us: decode 85-95, predict 95-100, the client 100-150; the next request's
    # predict 150-155, encode 155-165, user_vectors 165-175, topk 175-190
    assert by == {"predict.decode": 10 * US, "predict": 10 * US, lib_spans.OUTSIDE: 50 * US,
                  "predict.encode": 10 * US, "predict.user_vectors": 10 * US, "predict.topk": 15 * US}
    assert sum(by.values()) == 105 * US


def test_device_records_are_aligned_by_the_blocking_copies():
    """The card's trace clock leading the host's by 1 ms and drifting:
    each request's upload ends 2 us before ``predict.encode`` does and its
    fetch copy 2 us before ``predict.fetch`` does, so the aligned records
    land within those 2 us of the host's clock."""
    sp = _serve_spans(requests=3)
    true = []
    for r in range(3):
        t = r * 150 * US
        true += [("Memcpy HtoD", t + 12 * US, t + 13 * US), ("k", t + 40 * US, t + 82 * US),
                 ("Memcpy DtoH", t + 82 * US, t + 83 * US)]
    lead = lambda t: 1000 * US + t // 100  # noqa: E731
    seen = [(n, a + lead(a), b + lead(a)) for n, a, b in true]
    anchors = (("predict.encode", "Memcpy HtoD"), ("predict.fetch", "Memcpy DtoH"))
    moved, shift = lib_spans.aligned(seen, sp, anchors)
    assert shift is not None and len(shift) == len(seen)
    assert all(abs(m[1] - t[1]) <= 2 * US + 10 and abs(m[2] - t[2]) <= 2 * US + 10 for m, t in zip(moved, true))
    got = lib_spans.idle_share_in(SimpleNamespace(trace=DeviceTrace(seen, 1.0)), sp, "predict", ("predict",), anchors)
    want = lib_spans.idle_share_in(SimpleNamespace(trace=DeviceTrace(true, 1.0)), sp, "predict", ("predict",))
    assert got == pytest.approx(want, abs=3.0)
    assert lib_spans.idle_share_in(SimpleNamespace(trace=DeviceTrace(seen, 1.0)), sp, "predict",
                                   ("predict",)) < want - 10  # unaligned, the idle falls outside predict
    _, none = lib_spans.aligned(seen[:-1], sp, anchors)  # a copy short: left as they are
    assert none is None


def _serve_run(sp_requests=2, window_s=300e-6):
    return SimpleNamespace(kind="serve", trace=DeviceTrace(_serve_device(), window_s), requests=sp_requests,
                           window_s=window_s, latencies=[1e-4] * sp_requests)


@pytest.fixture
def hand_made(monkeypatch):
    def install(sp):
        monkeypatch.setattr(profiling, "spans", lambda: list(sp))
    return install


def test_serve_readers_on_hand_made_spans(hand_made, capsys):
    hand_made(_serve_spans())
    run = _serve_run()
    got = {n: spec.metric_reader(n)(run) for n in
           ("encode_ms.serve", "topk_launch_ms.serve", "fetch_wait_ms.serve", "decode_ms.serve",
            "client_ms.serve", "idle_in_program.serve")}
    assert got["encode_ms.serve"] == pytest.approx(0.010)
    assert got["topk_launch_ms.serve"] == pytest.approx(0.020)
    assert got["fetch_wait_ms.serve"] == pytest.approx(0.040)
    assert got["decode_ms.serve"] == pytest.approx(0.010)
    assert got["client_ms.serve"] == pytest.approx((300 - 200) / 2 * 1e-3)  # window less both predicts
    assert got["idle_in_program.serve"] == pytest.approx(100 * 55 / 105)
    err = capsys.readouterr().err
    assert "by innermost span (s): " in err and "(no span) " in err and "self time a 'predict' span" in err
    for name in got:  # no trace, another kind of cell: nothing to read
        assert spec.metric_reader(name)(SimpleNamespace(kind="serve", trace=None)) is None
        assert spec.metric_reader(name)(SimpleNamespace(kind="fit", trace=None)) is None


def test_readers_raise_on_missing_spans_and_skip_an_older_port(hand_made, monkeypatch):
    hand_made([])
    with pytest.raises(RuntimeError, match="no 'predict' span"):
        spec.metric_reader("encode_ms.serve")(_serve_run())
    monkeypatch.delattr(profiling, "spans")  # a port without the recorder
    assert spec.metric_reader("encode_ms.serve")(_serve_run()) is None
    assert spec.metric_reader("idle_outside_steps.fit")(SimpleNamespace(kind="fit", trace=DeviceTrace([], 1))) is None


def test_fit_readers_on_hand_made_spans(hand_made, capsys):
    """One fit of 1000 us: feature tables 100, one epoch: build 200, pack
    50, steps 500 (two steps of 200), unpack 50, losses 50; the device busy
    during the steps only, 100-200 us of each step's tail."""
    sp = [Span("fit", 0, 1000 * US, -1, 0), Span("fit.train_data", 0, 20 * US, 0, 0),
          Span("fit.feature_tables", 20 * US, 120 * US, 0, 0), Span("epoch", 120 * US, 950 * US, 0, 0),
          Span("epoch.build", 120 * US, 320 * US, 3, 0), Span("epoch.pack", 320 * US, 370 * US, 3, 0),
          Span("epoch.steps", 370 * US, 870 * US, 3, 0), Span("step", 400 * US, 600 * US, 6, 0),
          Span("step", 600 * US, 800 * US, 6, 0), Span("epoch.unpack", 870 * US, 920 * US, 3, 0),
          Span("fit.losses", 950 * US, 1000 * US, 0, 0)]
    hand_made(sp)
    dev = [("k", 0, 10 * US), ("k", 500 * US, 600 * US), ("k", 700 * US, 800 * US), ("k", 990 * US, 1000 * US)]
    run = SimpleNamespace(kind="fit", trace=DeviceTrace(dev, 1e-3), epochs=1, steps=2)
    assert spec.metric_reader("feature_tables_ms.fit")(run) == pytest.approx(0.100)
    assert spec.metric_reader("epoch_build_ms.fit")(run) == pytest.approx(0.200)
    assert spec.metric_reader("step_host_ms.fit")(run) == pytest.approx(0.200)
    # idle: 10-500 (370-500 in steps) and 600-700 (in steps) and 800-990 (800-870 in steps): 780 us,
    # 300 in steps
    assert spec.metric_reader("idle_outside_steps.fit")(run) == pytest.approx(100 * 480 / 780)
    err = capsys.readouterr().err
    assert "self time a 'fit' span (ms): " in err and "epoch.steps 0.1000" in err
    with pytest.raises(RuntimeError, match="1 'fit' spans in a window of 2"):
        spec.metric_reader("feature_tables_ms.fit")(SimpleNamespace(kind="fit", trace=run.trace, epochs=2))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace's clock is read there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_encloses_its_kernel_on_the_device_trace_clock(cuda_device):
    """A span around a launch of a spin kernel and a synchronise holds the
    kernel's kineto interval, on every try, under the benchmark's CUDA-only
    profiler and under a host-and-device one."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiling.reset()
        with profile(activities=acts) as p:
            time.sleep(0.05)
            for i in range(40):
                with profiling.annotate("spin"):
                    torch.cuda._sleep(100_000 * (1 + i % 4))
                    torch.cuda.synchronize()
            time.sleep(0.05)
        kern = sorted((e.start_ns(), e.end_ns()) for e in p.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA and "spin" in e.name())
        sp = profiling.spans()
        assert len(sp) == 40 and len(kern) == 40
        assert all(s.start_ns <= k0 and k1 <= s.end_ns for s, (k0, k1) in zip(sp, kern)), acts

"""Profiling hooks (port of ``torchrecsys_tpu/utils/profiling.py``).

:func:`trace` captures a ``torch.profiler`` trace around a block (host ops,
and the CUDA kernels when a card is present) into a Chrome trace file,
viewable in Perfetto or ``chrome://tracing``; :func:`op_summary` prints the
per-op digest of the newest trace in a directory.
``TrainConfig.profile_epochs`` runs the first epochs of ``Trainer.fit``
inside :func:`trace` and logs the digest once.

Spans. :func:`annotate` names a region of the program: ``predict`` and its
steps in the facade, ``fit``, ``epoch`` and ``step`` in the trainer (the
full list is in PERF.md). A span records only while a ``torch.profiler``
session is active (:func:`trace`, ``profile_epochs``, or the caller's own
``torch.profiler.profile``); otherwise it costs one flag check and records
nothing. A span never synchronises and never reads a tensor. Each record
holds the name, start and end on the clock of the profiler's own events
(``time.time_ns()``: the kineto events' ``start_ns()``), the index of its
parent span in the buffer (-1 for a root) and the index of its root span
(the request or the ``fit`` call). The card's records agree with that
clock at the start of a session, but on an H100 host they drifted
from it by up to ~10 ms within a 20 s session, so a reader that lays
device records over spans aligns them first (the benchmark does so by the
program's blocking copies, ``perfbench/lib/spans.py``). When the profiler
records host activity the span also opens a profiler range of the same
name, so the Chrome trace shows it (among the host ops). An operator reads
:func:`spans` after the profiled block: a list of :class:`Span`, in the
order they opened, at most :data:`MAX_SPANS` of them (later ones are
counted in ``spans.dropped``); :func:`reset` empties the buffer.

Counters. :func:`counters` is a snapshot of the program's event counts,
always on: ``catalog.builds`` (the facade's kept serving catalog built),
``seen_index.builds`` (its by-user seen index built), ``dot_topk.plans``
and ``dot_topk.tensor_maps`` (the top-k kernels' plan and TMA-map cache
misses), ``kernels.built`` (``nvcc`` runs), ``fit.train_data_uploads``
(the trainer's train split uploaded), ``fit.feature_table_builds``
(``Trainer.feature_tables`` calls) and ``spans.dropped``. The kernel
wrappers' ``.launches`` attributes count launches apart from these.

torch.profiler can drop the first kernels of its active phase and
kernels that end in its last milliseconds (seen on the H100 late in a
long run). So :func:`trace` starts the profiler in a warm-up step whose
records are dropped, then, in the active step, launches
``LEAD_IN_KERNELS`` short spin kernels under the :data:`LEAD_IN`
annotation before the block (the digest sets them aside), and
synchronises and settles before it stops.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from torchrecsys_tpu_torch.utils import trace_files
from torchrecsys_tpu_torch.utils.logging import get_logger
from torchrecsys_tpu_torch.utils.trace_files import LEAD_IN

log = get_logger("torchrecsys_tpu_torch.profiling")

LEAD_IN_KERNELS = 16
SETTLE_S = 0.05  # the card idle before the lead-in and after the block


def default_trace_dir() -> str:
    """``<temp dir>/torchrecsys_tpu_torch_trace`` (``/tmp/...`` unless
    ``TMPDIR`` says otherwise)."""
    return os.path.join(tempfile.gettempdir(), "torchrecsys_tpu_torch_trace")


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around a block (profiling.py:23-39)
    into one new ``<host>_<pid>.<ns>.pt.trace.json`` under ``trace_dir``
    (default :func:`default_trace_dir`): host ops, and the CUDA kernels
    when a card is present."""
    trace_dir = trace_dir or default_trace_dir()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def settle() -> None:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)

    t0 = time.perf_counter()
    with profile(
        activities=activities,
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path),
    ) as prof:
        if cuda:  # the warm-up step: the tracer starts, its records are dropped
            torch.cuda._sleep(1000)
        settle()
        prof.step()
        if cuda:
            with record_function(LEAD_IN):
                for _ in range(LEAD_IN_KERNELS):
                    torch.cuda._sleep(1000)
        try:
            yield
        finally:
            settle()
            prof.step()
    log.info(
        "profiler trace captured (%.2fs) -> %s (view: Perfetto or chrome://tracing)",
        time.perf_counter() - t0,
        trace_dir,
    )


MAX_SPANS = 1 << 20
COUNTERS = (
    "catalog.builds",
    "seen_index.builds",
    "dot_topk.plans",
    "dot_topk.tensor_maps",
    "kernels.built",
    "fit.train_data_uploads",
    "fit.feature_table_builds",
    "spans.dropped",
)

_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


def count(name: str) -> None:
    """Add one to the counter ``name`` (one of :data:`COUNTERS`)."""
    _counts[name] += 1


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


class Span(NamedTuple):
    """One span: ``start_ns`` and ``end_ns`` on the profiler's clock
    (``end_ns`` is -1 while it is open); ``parent`` and ``root`` index
    :func:`spans` (``parent`` -1 for a root, whose ``root`` is itself)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


# The span buffer, one flat list per field (no object per span for the
# garbage collector to scan): name, start, end (-1 while open), parent, root.
_names: List[str] = []
_starts: List[int] = []
_ends: List[int] = []
_parents: List[int] = []
_roots: List[int] = []


class _OpenSpans(threading.local):
    def __init__(self) -> None:
        self.stack: List[tuple] = []  # (index, root) of this thread's open spans


_open = _OpenSpans()
_profiling = torch.autograd._profiler_enabled
_clock = time.time_ns
_RangeOf = torch._C._profiler._RecordFunctionFast  # a no-op unless host activity is recorded


class _Span:
    __slots__ = ("_name", "_index", "_range")

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> None:
        i = self._index = len(_names)
        if i >= MAX_SPANS:
            _counts["spans.dropped"] += 1
            return
        stack = _open.stack
        parent, root = stack[-1] if stack else (-1, i)
        self._range = _RangeOf(self._name)
        self._range.__enter__()
        _names.append(self._name)
        _parents.append(parent)
        _roots.append(root)
        _ends.append(-1)
        _starts.append(_clock())
        stack.append((i, root))

    def __exit__(self, *exc) -> None:
        if self._index < MAX_SPANS:
            _ends[self._index] = _clock()
            self._range.__exit__(None, None, None)
            _open.stack.pop()


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` around a block (see the module docstring): a
    no-op unless a torch.profiler session is active."""
    return _Span(name) if _profiling() else _OFF


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return [Span(*r) for r in zip(_names, _starts, _ends, _parents, _roots)]


def reset() -> None:
    """Empty the span buffer and zero ``spans.dropped``; call it with no
    span open."""
    for buf in (_names, _starts, _ends, _parents, _roots):
        buf.clear()
    _counts["spans.dropped"] = 0


def op_summary(trace_dir: Optional[str] = None, row_limit: int = 20) -> str:
    """The per-op digest of the newest trace under ``trace_dir``
    (profiling.py:48-61): per device, the top ``row_limit`` kernels by
    total time (on the CPU the host's ops by self time, approximate). It
    never raises: a directory without a trace and a file it cannot read
    give a one-line note instead."""
    trace_dir = trace_dir or default_trace_dir()
    path = trace_files.latest_trace_file(trace_dir)
    if path is None:
        return f"(no *.pt.trace.json trace found under {trace_dir})"
    try:
        return trace_files.format_op_table(path, row_limit=row_limit)
    except Exception as e:  # a digest must never break training
        return f"(failed to parse trace {path}: {type(e).__name__}: {e})"

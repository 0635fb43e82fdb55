"""The program's own spans of a traced window, reduced to what metrics read.

With ``--trace 1`` the window runs under ``torch.profiler``, so the port's
span recorder (``torchrecsys_tpu_torch.utils.profiling``: ``spans()``,
``counters()``) holds the spans of the window and nothing else: set-up and
the check run without the profiler. Spans are stamped on the clock of the
device trace's records (kineto's ``start_ns()``: ``time.time_ns()``), so
device-idle stretches can be laid over them. A span is ``(name, start_ns, end_ns, parent,
root)``; ``parent`` and ``root`` index the list. The device records' clock
agrees with the spans' at the start of a profiler session, but it can
drift from it by milliseconds within a 20 s window, so the readers that lay
idle stretches over spans first align the records (:func:`aligned`).

- :func:`window_spans`: the spans, or None when the run was not traced or
  the program has no span recorder (an older port);
- :func:`per_root_ms`: a child span's total time over the number of root
  spans (per request, per ``fit`` call), in ms;
- :func:`self_ns`, :func:`self_ms_by_name`: a span's duration less the
  part its children cover;
- :func:`idle_intervals`: the device's idle stretches between its
  operations;
- :func:`innermost`: the time some span is open, cut into pieces each
  named by the innermost open span;
- :func:`overlap_by_name`: idle time by the innermost span over it;
- :func:`aligned`: the device records moved onto the spans' clock by the
  program's blocking copies (the card's trace clock drifts from the host's
  by up to milliseconds within a window on an H100 host);
- :func:`idle_share_in`: the share of idle time under given spans.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

OUTSIDE = "(no span)"

Interval = Tuple[int, int]


def window_spans(run) -> Optional[list]:
    """The spans of the traced window. None without a trace or
    without the program's recorder; raises when the recorder dropped
    spans."""
    if run.trace is None:
        return None
    from torchrecsys_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    dropped = profiling.counters()["spans.dropped"]
    if dropped:
        raise RuntimeError(f"the span buffer overflowed: {dropped} spans dropped")
    return profiling.spans()


def roots(spans: Sequence, name: str) -> List[int]:
    """Indexes of the root spans named ``name``; raises when there are
    none."""
    got = [i for i, s in enumerate(spans) if s.parent == -1 and s.name == name]
    if not got:
        raise RuntimeError(f"no {name!r} span in the traced window")
    return got


def per_root_ms(spans: Sequence, root: str, child: str, expect: Optional[int] = None) -> float:
    """The total time of the spans named ``child`` under roots named
    ``root``, over the number of those roots, in ms. Raises when there is
    no such root or child, or when ``expect`` is given and the roots are
    not that many."""
    top = set(roots(spans, root))
    if expect is not None and len(top) != expect:
        raise RuntimeError(f"{len(top)} {root!r} spans in a window of {expect}")
    durs = [s.end_ns - s.start_ns for s in spans if s.name == child and s.root in top]
    if not durs:
        raise RuntimeError(f"no {child!r} span under {root!r} in the traced window")
    return sum(durs) / len(top) * 1e-6


def mean_ms(spans: Sequence, name: str) -> float:
    """The mean duration of the spans named ``name``, in ms."""
    durs = [s.end_ns - s.start_ns for s in spans if s.name == name]
    if not durs:
        raise RuntimeError(f"no {name!r} span in the traced window")
    return sum(durs) / len(durs) * 1e-6


def self_ns(spans: Sequence) -> List[int]:
    """Each span's duration less its children's."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def idle_intervals(records: Iterable[Tuple[str, int, int]]) -> List[Interval]:
    """The stretches between the device's busy stretches, from its
    operations ``(name, start_ns, end_ns)`` sorted by start."""
    gaps = []
    end = None
    for _, s, e in records:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def innermost(spans: Sequence) -> List[Tuple[int, int, str]]:
    """``(start, end, name)`` pieces of the time some span in ``spans`` is
    open, in order, each named by the innermost open span (spans of one
    thread nest)."""
    out = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the open spans
    t = 0
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s.start_ns, stack[-1][1]))
        stack.append((s.end_ns, s.name))
        t = s.start_ns
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [p for p in out if p[1] > p[0]]


def overlap_by_name(gaps: Sequence[Interval], pieces: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Nanoseconds of ``gaps`` under each piece's name, and under
    :data:`OUTSIDE` where no piece lies; both lists sorted and disjoint."""
    out: Dict[str, int] = {}
    j = 0
    for lo, hi in gaps:
        while j < len(pieces) and pieces[j][1] <= lo:
            j += 1
        covered = 0
        k = j
        while k < len(pieces) and pieces[k][0] < hi:
            a, b, name = pieces[k]
            ov = min(b, hi) - max(a, lo)
            if ov > 0:
                out[name] = out.get(name, 0) + ov
                covered += ov
            k += 1
        if hi - lo > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0) + (hi - lo - covered)
    return out


def self_ms_by_name(spans: Sequence, root: str) -> Dict[str, float]:
    """Self time of the spans under roots named ``root``, summed by name,
    over the number of those roots, in ms."""
    top = set(roots(spans, root))
    out: Dict[str, float] = {}
    for s, own in zip(spans, self_ns(spans)):
        if s.root in top:
            out[s.name] = out.get(s.name, 0.0) + own * 1e-6 / len(top)
    return out


def aligned(records: Sequence[Tuple[str, int, int]], spans: Sequence,
            anchors: Sequence[Tuple[str, str]]) -> Tuple[list, Optional[np.ndarray]]:
    """The device records ``(name, start_ns, end_ns)`` moved onto the spans'
    clock, and each record's shift in ns (None: left as they are). The
    card's trace clock can lead or lag the host's by milliseconds, drifting
    within a window. An anchor is a span that blocks on one device
    operation (``(span name, operation name)``, e.g. the fetch and its
    ``Memcpy DtoH``): the k-th such span waits for the k-th such operation,
    which ends before the span does, so the operation's end less the span's
    end is a lower bound of the device clock's lead at that moment, tight
    to the host's wake-up. The lead is the largest bound of an anchor and
    its two neighbours in device time, interpolated between anchors. Where
    an anchor's spans and operations differ in number, the records are left
    as they are."""
    points = []
    for span_name, op in anchors:
        ends = [s.end_ns for s in spans if s.name == span_name]
        ops = [e for n, _, e in records if op in n]
        if not ends or len(ops) != len(ends):
            return list(records), None
        points += [(e, e - b) for e, b in zip(ops, ends)]
    if not points:
        return list(records), None
    points.sort()
    t = np.array([p[0] for p in points], dtype=np.float64)
    bound = np.array([p[1] for p in points], dtype=np.float64)
    lead = np.maximum(bound, np.maximum(np.r_[bound[:1], bound[:-1]], np.r_[bound[1:], bound[-1:]]))
    shift = np.rint(np.interp([r[1] for r in records], t, lead)).astype(np.int64)
    moved = [(n, s - int(d), e - int(d)) for (n, s, e), d in zip(records, shift)]
    return sorted(moved, key=lambda r: r[1]), shift


def idle_share_in(run, spans: Sequence, root: str, names: Sequence[str],
                  anchors: Sequence[Tuple[str, str]] = ()) -> float:
    """The share of the device's idle time (between its operations) during
    which a span named in ``names`` was open, in %, the device records
    :func:`aligned` by ``anchors``. Also writes three lines to standard
    error: the alignment, the idle seconds by innermost open span, and the
    self time of each span under roots named ``root`` per root."""
    records, shift = aligned(run.trace.records, spans, anchors)
    if shift is None:
        note = "device records left on the trace's clock" + (f": no anchor of {list(anchors)} matched" if anchors
                                                               else "")
    else:
        note = f"device records aligned by {list(anchors)}: shift {shift.min() * 1e-6:.3f}..{shift.max() * 1e-6:.3f} ms"
    gaps = idle_intervals(records)
    total = sum(hi - lo for lo, hi in gaps)
    if not total:
        raise RuntimeError("the device never idled in the traced window")
    by_span = overlap_by_name(gaps, innermost(spans))
    own = self_ms_by_name(spans, root)
    print(f"[perfbench] {note}", file=sys.stderr, flush=True)
    print(f"[perfbench] device idle {total * 1e-9:.4f} s between operations, by innermost span (s): "
          + ", ".join(f"{k} {v * 1e-9:.4f}" for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    print(f"[perfbench] self time a {root!r} span (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(own.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    inside = overlap_by_name(gaps, innermost([s for s in spans if s.name in names]))
    return 100.0 * (total - inside.get(OUTSIDE, 0)) / total

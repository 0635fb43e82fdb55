"""Per-op digests of the traces ``torch.profiler`` writes (the port's
counterpart of ``torchrecsys_tpu/utils/xplane.py``).

``torch.profiler`` exports Chrome trace JSON (``*.pt.trace.json``, or
gzipped), so there is no protobuf to decode. Each event is one object of
``traceEvents``: ``ph`` ``"X"`` for a complete event with ``ts`` and
``dur`` in µs, ``cat`` its kind. On the card the device's work is the
events of category ``kernel`` (one per CUDA kernel, ``args["device"]``
its card); on the CPU only host events exist, ``cpu_op`` (one per torch
op call, nested inside the ops that called them).

:func:`op_totals` sums each device's kernels by name; without a device it
sums the host's ``cpu_op`` events by self time (the op's duration less its
children's), labelled approximate as xplane labels its host threads
(xplane.py:187-207). Work launched under the :data:`LEAD_IN` annotation
(the profiler's lead-in, utils/profiling.py) is set aside: its host ops by
their time range on the annotating thread, its kernels by the correlation
id of the runtime call that launched them inside that range.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

LEAD_IN = "torchrecsys_tpu_torch.lead_in"
HOST_LABEL = "/host:CPU / cpu_op self time (approx)"

Rows = List[Tuple[str, float, int]]


def latest_trace_file(trace_dir: str) -> Optional[str]:
    """The newest ``*.pt.trace.json`` or ``*.pt.trace.json.gz`` under
    ``trace_dir``, searched recursively (xplane.py:133-135); None if none."""
    files = [
        f
        for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
        for f in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    ]
    return max(files, key=os.path.getmtime) if files else None


def read_events(path: str) -> List[dict]:
    """The complete (``ph == "X"``) events of a Chrome trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X"]


def _lead_in_sets(events: List[dict]) -> Tuple[List[Tuple[object, object, float, float]], set]:
    """The lead-in's (pid, tid, start, end) ranges and the correlation ids
    of the kernels launched inside them."""
    ranges = [
        (e.get("pid"), e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0.0))
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") == LEAD_IN
    ]
    corr = {
        e["args"]["correlation"]
        for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
        and _inside(e, ranges)
    }
    return ranges, corr


def _inside(e: dict, ranges) -> bool:
    return any(
        e.get("pid") == pid and e.get("tid") == tid and lo <= e["ts"] <= hi for pid, tid, lo, hi in ranges
    )


def _sorted_rows(agg: Dict[str, List[float]]) -> Rows:
    return sorted(((k, v[0], int(v[1])) for k, v in agg.items()), key=lambda t: -t[1])


def _host_self_times(ops: List[dict]) -> Dict[str, List[float]]:
    """``cpu_op`` events summed by name over their self time: per thread,
    a stack of the enclosing ops takes each op's duration off its parent."""
    agg: Dict[str, List[float]] = {}
    by_thread: Dict[tuple, List[dict]] = {}
    for e in ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[list] = []  # [end, name, self time]
        for e in evs:
            dur = float(e.get("dur", 0.0))
            while stack and e["ts"] >= stack[-1][0]:
                _, name, self_us = stack.pop()
                a = agg.setdefault(name, [0.0, 0])
                a[0] += self_us
                a[1] += 1
            if stack:
                stack[-1][2] -= dur
            stack.append([e["ts"] + dur, e["name"], dur])
        for _, name, self_us in stack:
            a = agg.setdefault(name, [0.0, 0])
            a[0] += self_us
            a[1] += 1
    return agg


def op_totals(path: str, include_host: bool = False) -> Dict[str, Rows]:
    """Per device, ``[(name, total_us, count), ...]`` sorted by total
    (xplane.py:138-171): each card's CUDA kernels summed by name, keyed
    ``/device:cuda:<n> / kernels``; with ``include_host`` also the host's
    ``cpu_op`` events summed by self time, keyed :data:`HOST_LABEL`. The
    lead-in's work is left out."""
    events = read_events(path)
    ranges, lead_corr = _lead_in_sets(events)
    out: Dict[str, Rows] = {}
    per_device: Dict[str, Dict[str, List[float]]] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        args = e.get("args", {})
        if args.get("correlation") in lead_corr:
            continue
        a = per_device.setdefault(f"/device:cuda:{args.get('device', 0)} / kernels", {}).setdefault(
            e["name"], [0.0, 0]
        )
        a[0] += float(e.get("dur", 0.0))
        a[1] += 1
    for device, agg in sorted(per_device.items()):
        out[device] = _sorted_rows(agg)
    if include_host:
        ops = [e for e in events if e.get("cat") == "cpu_op" and not _inside(e, ranges)]
        if ops:
            out[HOST_LABEL] = _sorted_rows(_host_self_times(ops))
    return out


def kernel_base_name(name: str) -> str:
    """A CUDA kernel's function name without its return type, namespaces,
    template arguments and parameters (``void ns::k<1, true>(Args)`` ->
    ``k``)."""
    return re.split(r"[<(]", _display(name), maxsplit=1)[0].split("::")[-1]


def _display(name: str) -> str:
    """A kernel's name without the ``void`` and ``(anonymous namespace)::``
    that start most of them (the table keeps 60 characters)."""
    return re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))


def _fmt_time(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.1f}us"


def format_op_table(path: str, row_limit: int = 20) -> str:
    """The per-op digest (xplane.py:209-225): one block per device, the top
    ``row_limit`` ops by total time with the columns ``op total avg count
    %``, then a ``TOTAL`` line; a trace without device kernels (the CPU)
    gives the host's ops by self time, labelled approximate."""
    totals = op_totals(path)
    if not totals:
        totals = op_totals(path, include_host=True)
    blocks: List[str] = []
    for label, rows in totals.items():
        grand = sum(t for _, t, _ in rows) or 1.0
        names = [_display(r[0])[:60] for r in rows[:row_limit]]
        w = max([len(n) for n in names] + [8])
        hdr = f"{'op':<{w}}  {'total':>10}  {'avg':>10}  {'count':>7}  {'%':>6}"
        lines = [f"[{label}]", hdr, "-" * len(hdr)]
        for name, (_, tot, cnt) in zip(names, rows[:row_limit]):
            lines.append(
                f"{name:<{w}}  {_fmt_time(tot):>10}  "
                f"{_fmt_time(tot / cnt):>10}  {cnt:>7}  {100 * tot / grand:>5.1f}%"
            )
        lines.append(f"{'TOTAL':<{w}}  {_fmt_time(grand):>10}")
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks) if blocks else "(no device ops found in trace)"

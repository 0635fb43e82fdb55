"""The device trace of a measured window, reduced to what metrics read.

``torch.profiler`` records the card's activity (CUDA only: recording every
host op would slow the host path that several cells are paced by). Before
the window 16 short spin kernels run, and their records are set aside: the
profiler has been seen to drop the first kernels of an active phase on
this card, and these absorb that. Reduction:

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills), so overlapping streams count once;
- ``ops``: device seconds by operation name (template arguments cut);
- ``gaps``: idle stretches between device operations, named by the
  operation before and after them ("what the host was launching").
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import torch

LEAD_IN = 16
SETTLE_S = 0.05
_SPIN = "spin_kernel"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments or parameters."""
    name = re.sub(r"^void\s+", "", name)
    cut = len(name)
    for ch in "<(":
        i = name.find(ch)
        if i > 0:
            cut = min(cut, i)
    return name[:cut].strip() or name


class DeviceTrace:
    """The device operations of one window: (name, start_ns, end_ns)."""

    def __init__(self, ops: List[Tuple[str, int, int]], window_s: float) -> None:
        self.records = sorted(ops, key=lambda r: r[1])
        self.window_s = window_s
        self.busy_s, self.gaps = self._union()

    def _union(self) -> Tuple[float, Dict[str, float]]:
        """Busy seconds (the union of the intervals) and the idle gaps'
        seconds by "<op before> -> <op after>"."""
        busy = 0
        gaps: Dict[str, float] = {}
        start = end = None
        last = ""  # the op that ends the current busy stretch
        for name, s, e in self.records:
            if end is None or s > end:
                if end is not None:
                    busy += end - start
                    label = f"{short_name(last)} -> {short_name(name)}"
                    gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-9
                start, end, last = s, e, name
            elif e > end:
                end, last = e, name
        if end is not None:
            busy += end - start
        return busy * 1e-9, gaps

    def seconds(self, substring: str) -> float:
        """Device seconds of the operations whose name holds ``substring``."""
        return sum(e - s for n, s, e in self.records if substring in n) * 1e-9

    def ops(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.records:
            k = short_name(n)
            out[k] = out.get(k, 0.0) + (e - s) * 1e-9
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops = sorted(self.ops().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Window:
    """Times a measured window by the host clock and, when ``traced``,
    records it with torch.profiler. ``seconds`` is the host window."""

    def __init__(self, traced: bool, device: torch.device) -> None:
        self.traced = traced and device.type == "cuda"
        self.device = device
        self.trace: Optional[DeviceTrace] = None
        self._prof = None
        self.start = self.end = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "Window":
        self.sync()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            time.sleep(SETTLE_S)
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
        self.start = time.perf_counter()
        return self

    def close(self) -> None:
        """End the window: the device is synchronised first."""
        self.sync()
        self.end = time.perf_counter()

    def __exit__(self, *exc) -> None:
        if not self.end:
            self.close()
        if self._prof is not None:
            time.sleep(SETTLE_S)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = DeviceTrace(self._device_ops(), self.seconds)
            self._prof = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _device_ops(self) -> List[Tuple[str, int, int]]:
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            if _SPIN in name:
                continue
            out.append((name, int(e.start_ns()), int(e.end_ns())))
        return out

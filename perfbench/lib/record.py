"""What one run recorded: the facts every metric reader reads.

A driver fills a :class:`Run`; each metric of ``perfbench/metrics/`` is a
function of it. Times are host-clock seconds unless named otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from perfbench.lib.trace import DeviceTrace


@dataclasses.dataclass
class Run:
    kind: str  # the driver: "serve" or "fit"
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window, host clock
    # serve: one latency (s) per request completed in the window
    latencies: List[float] = dataclasses.field(default_factory=list)
    users_per_request: int = 0
    # fit: whole epochs, steps and real (non-filler) training rows in the window
    epochs: int = 0
    steps: int = 0
    examples: int = 0
    # the port's kernel launches in the window, by wrapper
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the shapes the metrics' arithmetic takes (U, N, D, k, B, L, blocks, dtype)
    shapes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[DeviceTrace] = None

    @property
    def requests(self) -> int:
        return len(self.latencies)

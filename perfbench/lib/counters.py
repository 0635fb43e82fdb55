"""The port's kernel launch counters (``<wrapper>.launches``), by the
dotted name a traffic file gives them, e.g. ``ops.dot_topk.dot_topk_small``
for ``torchrecsys_tpu_torch.ops.dot_topk.dot_topk_small``."""

from __future__ import annotations

import importlib
from typing import Dict, Iterable, List


def read(names: Iterable[str]) -> Dict[str, int]:
    out = {}
    for name in names:
        mod, _, attr = name.rpartition(".")
        fn = getattr(importlib.import_module(f"torchrecsys_tpu_torch.{mod}"), attr)
        out[name] = int(fn.launches)
    return out


def misses(per_unit: Dict[str, int], before: Dict[str, int], after: Dict[str, int], units: int) -> List[str]:
    """Counters whose launches in the window are not ``per_unit x units``:
    the traffic missed the mechanism its cell is for."""
    bad = []
    for name, per in per_unit.items():
        got = after[name] - before[name]
        if got != per * units:
            bad.append(f"{name}: {got} launches, expected {per} x {units}")
    return bad

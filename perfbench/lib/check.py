"""The numbers a run compares with the plain reference, each beside its
limit, and the readings of a training check.

A run is ``correct`` when every number is at or under its limit (an exact
comparison has the limit 0). The limits of a cell are in
``perfbench/limits/<workload>.json``; PERF.md gives the readings each was
set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple


class Check:
    def __init__(self, limits: Dict[str, float]) -> None:
        self.limits = limits
        self.items: List[Tuple[str, float, float]] = []
        self.notes: List[str] = []

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r} in this cell's limits file")
        self.items.append((name, float(value), float(self.limits[name])))

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def lines(self) -> List[str]:
        return [f"check {n}: {v!r} (limit {lim!r}) {'ok' if math.isfinite(v) and v <= lim else 'FAILS'}"
                for n, v, lim in self.items]


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose first reference gradient is at least a thousandth of the
    median leaf's; the rest move by round-off alone (adam scales a gradient
    that is nought to rounding up to steps of the learning rate)."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= 1e-3 * med]


def _median_and_worst(gaps: Dict[str, float]) -> Tuple[float, float, str]:
    if not gaps:
        return math.inf, math.inf, ""
    vals = [v if math.isfinite(v) else math.inf for v in gaps.values()]
    worst = max(gaps, key=lambda k: gaps[k] if math.isfinite(gaps[k]) else math.inf)
    return statistics.median(vals), gaps[worst], worst


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a training check compares: ``loss_gap``, the first
    step's relative loss gap; ``grad_gap``, the median leaf's gap of first
    gradient norms; ``change_gap``, the median moving leaf's gap of the
    parameters' change after the last step. The worst step's loss gap and
    the worst leaves' gaps (``worst_*``) are reported beside them: they
    carry the round-off that adam amplifies in the later steps and the
    cancellation in a bias's sum over every position, and swing from seed
    to seed by orders of magnitude."""
    if len(prog["losses"]) != len(ref["losses"]) or not ref["losses"]:
        return {k: math.inf for k in ("loss_gap", "grad_gap", "change_gap", "worst_loss_gap",
                                      "worst_grad_gap", "worst_change_gap")} | {"_grad_leaf": "", "_change_leaf": ""}
    steps = [rel_gap(p, r) for p, r in zip(prog["losses"], ref["losses"])]
    grad_med, grad_worst, g_at = _median_and_worst(leaf_gaps(prog["grad_norms"], ref["grad_norms"],
                                                             list(ref["grad_norms"])))
    moving = moving_leaves(ref["grad_norms"])
    change_med, change_worst, c_at = _median_and_worst(leaf_gaps(prog["change_norms"], ref["change_norms"], moving))
    return {"loss_gap": steps[0], "grad_gap": grad_med, "change_gap": change_med,
            "worst_loss_gap": max(steps), "worst_grad_gap": grad_worst, "worst_change_gap": change_worst,
            "_grad_leaf": g_at, "_change_leaf": c_at}

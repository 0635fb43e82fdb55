"""Kernels #4/#5 (``softmax_ce_*``: split, forward, combine, backward and
its sum): the least time the card could take for one step's forward and
backward at B x B x D (lib/roofline.py) over their device time per step in
the traced window, in %."""

from perfbench.lib import roofline


def read(run):
    calls = run.launches.get("ops.softmax_ce.softmax_ce_fwd", 0)
    if run.kind != "fit" or run.trace is None or not calls:
        return None
    dev_s = run.trace.seconds("softmax_ce")
    if dev_s <= 0:
        return None
    b, d = run.shapes["B"], run.shapes["D"]
    return 100.0 * (roofline.ce_fwd_bound_s(b, d) + roofline.ce_bwd_bound_s(b, d)) / (dev_s / calls)

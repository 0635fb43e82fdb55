"""Kernels #1/#2 (``dot_topk_tc_kernel``) with their split merge
(``dot_topk_merge_kernel``): the least time the card could take for one
call at the request's shape (U x N x D, k; lib/roofline.py) over the
device time per call in the traced window, in %."""

from perfbench.lib import roofline


def read(run):
    calls = run.launches.get("ops.dot_topk.dot_topk_small", 0) + run.launches.get("ops.dot_topk.dot_topk_large", 0)
    if run.kind != "serve" or run.trace is None or not calls:
        return None
    dev_s = run.trace.seconds("dot_topk")
    if dev_s <= 0:
        return None
    s = run.shapes
    return 100.0 * roofline.topk_bound_s(s["U"], s["N"], s["D"], s["k"], s["dtype"]) / (dev_s / calls)

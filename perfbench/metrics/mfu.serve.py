"""The whole request's share of the card's peak: 2 U N D operations per
request, times the requests of the traced window, over its time and the
peak of the configuration's precision (lib/roofline.py), in %."""

from perfbench.lib import roofline


def read(run):
    if run.kind != "serve" or run.trace is None or not run.requests:
        return None
    s = run.shapes
    flops = roofline.topk_flops(s["U"], s["N"], s["D"]) * run.requests
    return 100.0 * flops / run.window_s / roofline.PEAK_FLOPS[s["dtype"]]

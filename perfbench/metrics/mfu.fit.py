"""The whole training step's share of the card's peak: model operations
per training row (recompute not counted; lib/roofline.py) times the rows
of the traced window, over its time and the peak of the configuration's
precision, in %. Known for in-batch softmax MF and for SASRec."""

from perfbench.lib import roofline


def read(run):
    if run.kind != "fit" or run.trace is None or not run.examples:
        return None
    s = run.shapes
    if s["net"] == "linear" and run.traffic["train"]["loss"] == "sampled_softmax":
        per = roofline.mf_softmax_flops_per_example(s["B"], s["D"])
    elif s["net"] == "sasrec":
        per = roofline.sasrec_flops_per_example(s["D"], s["L"], s["blocks"])
    else:
        return None
    return 100.0 * per * run.examples / run.window_s / roofline.PEAK_FLOPS[s["dtype"]]

"""HSTU's training step's share of the card's peak: HSTU's model
operations per training row (lib/roofline_hstu.py, the blocks and heads
read from the configuration's ``port``) times the rows of the traced
window, over its time and the peak of the configuration's precision
(lib/roofline.py), in %. None for other nets."""

from perfbench.lib import roofline
from perfbench.lib.roofline_hstu import hstu_flops_per_example


def read(run):
    if run.kind != "fit" or run.trace is None or not run.examples:
        return None
    port = run.config["port"]
    if port.get("net_type") != "hstu":
        return None
    per = hstu_flops_per_example(int(port["n_factors"]), int(port["history_len"]), int(port["hstu_blocks"]),
                                 int(port["hstu_heads"]))
    return 100.0 * per * run.examples / run.window_s / roofline.PEAK_FLOPS[run.config["dtype"]]

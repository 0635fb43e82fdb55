"""The epoch builder (the ``epoch.build`` span: round keys, the Feistel
permutation, the in-batch sort, the negatives) per epoch of the traced
window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "fit":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.mean_ms(sp, "epoch.build")

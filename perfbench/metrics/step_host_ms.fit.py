"""The host's dispatch of one training step (the mean ``step`` span of the
trainer's step loop) in the traced window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "fit":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.mean_ms(sp, "step")

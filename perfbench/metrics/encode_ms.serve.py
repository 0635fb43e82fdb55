"""The facade's encode of a request's raw user ids to rows (the
``predict.encode`` span of ``RecSys.predict``), per request of the traced
window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.per_root_ms(sp, "predict", "predict.encode", run.requests)

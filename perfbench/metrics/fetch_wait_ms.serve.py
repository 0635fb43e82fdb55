"""The host blocked on the card for the served ids (the ``predict.fetch``
span: ``ids.cpu()``, which waits for the top-k kernels and copies the
lists), per request of the traced window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.per_root_ms(sp, "predict", "predict.fetch", run.requests)

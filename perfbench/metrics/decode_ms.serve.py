"""The facade's decode of the served rows to raw item ids (the
``predict.decode`` span: the seen patch or filter and ``_decode_items``),
per request of the traced window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.per_root_ms(sp, "predict", "predict.decode", run.requests)

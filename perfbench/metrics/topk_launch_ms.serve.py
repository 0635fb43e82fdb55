"""The host's part of the top-k call (the ``predict.topk`` span around
``dot_topk`` in ``eval/predict.py``: the wrapper's checks, the padded rows,
the plan and TMA-map caches, the scratch allocation and the launches), per
request of the traced window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.per_root_ms(sp, "predict", "predict.topk", run.requests)

"""The trainer's feature tables (the ``fit.feature_tables`` span of
``Trainer.fit``: SASRec's history windows built and uploaded) per ``fit``
call of the traced window, in ms. Host clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "fit":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.per_root_ms(sp, "fit", "fit.feature_tables", run.epochs)

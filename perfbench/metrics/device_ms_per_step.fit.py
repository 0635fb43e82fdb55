"""Device busy time per training step in the traced window, in ms (the
epoch builds' device work included)."""


def read(run):
    if run.kind != "fit" or run.trace is None or not run.steps:
        return None
    return run.trace.busy_s / run.steps * 1e3

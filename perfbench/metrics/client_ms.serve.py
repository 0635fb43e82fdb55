"""The host's time outside the program per request: the traced window less
every ``predict`` span in it (the benchmark's client loop: drawing the
users, timing, keeping the check's sample), over the requests, in ms. Host
clock."""

from perfbench.lib import spans


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    if sp is None:
        return None
    top = spans.roots(sp, "predict")
    if len(top) != run.requests:
        raise RuntimeError(f"{len(top)} 'predict' spans in a window of {run.requests} requests")
    inside_s = sum(sp[i].end_ns - sp[i].start_ns for i in top) * 1e-9
    return (run.window_s - inside_s) / run.requests * 1e3

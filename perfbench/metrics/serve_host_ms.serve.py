"""The serving path's time outside the top-k kernels: the mean request
latency of the traced window less the device time of kernels #1/#2 and
their merge per request, in ms (``api.py`` encode and decode,
``eval/predict.py``, the user vectors, copies, waits)."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.requests:
        return None
    mean_s = sum(run.latencies) / run.requests
    return (mean_s - run.trace.seconds("dot_topk") / run.requests) * 1e3

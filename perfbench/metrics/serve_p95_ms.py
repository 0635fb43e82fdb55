"""95th percentile of every request's latency in the window, from the
``predict`` call to the raw ids on the host, in ms. Host clock."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.requests:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3

"""The share of the card's idle time (the stretches between its operations
in the traced window, aligned to the host's clock by each request's
blocking copies) during which a ``predict`` call was open, in %: the rest
is the client's. Writes the idle seconds by innermost open span, and
each span's self time a request, to standard error."""

from perfbench.lib import spans

# the blocking copies that align the device records: the rows' upload, the
# ids' fetch
ANCHORS = (("predict.encode", "Memcpy HtoD"), ("predict.fetch", "Memcpy DtoH"))


def read(run):
    if run.kind != "serve":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else spans.idle_share_in(run, sp, "predict", ("predict",), ANCHORS)

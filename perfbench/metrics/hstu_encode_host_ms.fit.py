"""Host time inside HSTU's encoder forward (the ``hstu.encode`` spans of
models/hstu.py: one a training step) per step of the traced window, in ms.
Host clock. None where the program records no such span.

What it reads depends on what paces the step. While the card paces it, as
the plain attention chains do at the cell's shapes, the host issues the
forward faster than the card runs it, fills CUDA's launch queue and waits
inside the span for room: the span then reads that backpressure, which
rises and falls with the device time of the steps before it, and not what
the host pays. Only once the step is host-paced (the card idle between
launches, ``idle_share.fit`` well above 0) does it read the cost of issuing
the forward. Read it beside ``idle_share.fit``, and take a fall of it as a
host-side gain only where that share is high on both sides."""

from perfbench.lib import spans


def read(run):
    if run.kind != "fit" or not run.steps:
        return None
    sp = spans.window_spans(run)
    if sp is None:
        return None
    durs = [s.end_ns - s.start_ns for s in sp if s.name == "hstu.encode"]
    if not durs:
        return None
    return sum(durs) / run.steps * 1e-6

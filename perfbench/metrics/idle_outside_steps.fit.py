"""The share of the card's idle time (the stretches between its operations
in the traced window) outside every ``epoch.steps`` span, in %: idle time
the step loop does not explain (epoch builds, feature tables, pack and
unpack, the loss read). Writes the idle seconds by innermost open span, and
each span's self time a ``fit`` call, to standard error. The records stay
on the trace's clock: no blocking copy of a fit matches one-to-one (the
loss read shares the D2H copies with others), and the stretches this reads
(~0.5 s at each call's start) dwarf the clock's drift."""

from perfbench.lib import spans


def read(run):
    if run.kind != "fit":
        return None
    sp = spans.window_spans(run)
    return None if sp is None else 100.0 - spans.idle_share_in(run, sp, "fit", ("epoch.steps",))

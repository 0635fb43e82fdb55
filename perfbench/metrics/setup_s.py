"""Seconds from the start of the run's process to the first timed request
or step: interpreter and torch start-up, inputs and weights from the seed,
the port's ingest, its kernels loaded (built on a checkout's first run)
and the cell's own shapes warmed up. Host clock."""


def read(run):
    return run.setup_s

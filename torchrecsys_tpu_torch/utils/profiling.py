"""Profiling hooks (port of ``torchrecsys_tpu/utils/profiling.py``).

:func:`trace` captures a ``torch.profiler`` trace around a block (host ops,
and the CUDA kernels when a card is present) into a Chrome trace file,
viewable in Perfetto or ``chrome://tracing``; :func:`annotate` names a
region of it; :func:`op_summary` prints the per-op digest of the newest
trace in a directory. ``TrainConfig.profile_epochs`` runs the first epochs
of ``Trainer.fit`` inside :func:`trace` and logs the digest once.

torch.profiler can drop the first kernels of its active phase and
kernels that end in its last milliseconds (seen on the H100 late in a
long run). So :func:`trace` starts the profiler in a warm-up step whose
records are dropped, then, in the active step, launches
``LEAD_IN_KERNELS`` short spin kernels under the :data:`LEAD_IN`
annotation before the block (the digest sets them aside), and
synchronises and settles before it stops.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from torchrecsys_tpu_torch.utils import trace_files
from torchrecsys_tpu_torch.utils.logging import get_logger
from torchrecsys_tpu_torch.utils.trace_files import LEAD_IN

log = get_logger("torchrecsys_tpu_torch.profiling")

LEAD_IN_KERNELS = 16
SETTLE_S = 0.05  # the card idle before the lead-in and after the block


def default_trace_dir() -> str:
    """``<temp dir>/torchrecsys_tpu_torch_trace`` (``/tmp/...`` unless
    ``TMPDIR`` says otherwise)."""
    return os.path.join(tempfile.gettempdir(), "torchrecsys_tpu_torch_trace")


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around a block (profiling.py:23-39)
    into one new ``<host>_<pid>.<ns>.pt.trace.json`` under ``trace_dir``
    (default :func:`default_trace_dir`): host ops, and the CUDA kernels
    when a card is present."""
    trace_dir = trace_dir or default_trace_dir()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def settle() -> None:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)

    t0 = time.perf_counter()
    with profile(
        activities=activities,
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path),
    ) as prof:
        if cuda:  # the warm-up step: the tracer starts, its records are dropped
            torch.cuda._sleep(1000)
        settle()
        prof.step()
        if cuda:
            with record_function(LEAD_IN):
                for _ in range(LEAD_IN_KERNELS):
                    torch.cuda._sleep(1000)
        try:
            yield
        finally:
            settle()
            prof.step()
    log.info(
        "profiler trace captured (%.2fs) -> %s (view: Perfetto or chrome://tracing)",
        time.perf_counter() - t0,
        trace_dir,
    )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace timeline (``record_function``)."""
    with record_function(name):
        yield


def op_summary(trace_dir: Optional[str] = None, row_limit: int = 20) -> str:
    """The per-op digest of the newest trace under ``trace_dir``
    (profiling.py:48-61): per device, the top ``row_limit`` kernels by
    total time (on the CPU the host's ops by self time, approximate). It
    never raises: a directory without a trace and a file it cannot read
    give a one-line note instead."""
    trace_dir = trace_dir or default_trace_dir()
    path = trace_files.latest_trace_file(trace_dir)
    if path is None:
        return f"(no *.pt.trace.json trace found under {trace_dir})"
    try:
        return trace_files.format_op_table(path, row_limit=row_limit)
    except Exception as e:  # a digest must never break training
        return f"(failed to parse trace {path}: {type(e).__name__}: {e})"

"""Structured logging (port of ``torchrecsys_tpu/utils/logging.py``).

Every component logs through a namespaced stdlib logger under
``torchrecsys_tpu_torch``; ``verbose=True`` paths emit at INFO. The first
call attaches one stdout handler (``[name] message``) to the package's
root logger, sets it to INFO and stops propagation (:18-30), so ``fit``
and ``evaluate`` print their epoch and eval lines as the reference's
prints do, and an embedding application can still silence or redirect
them through the stdlib.
"""

from __future__ import annotations

import logging
import sys

ROOT = "torchrecsys_tpu_torch"


class StdoutHandler(logging.StreamHandler):
    """A ``StreamHandler`` on ``sys.stdout`` as it is at each record, as
    ``print`` writes: a redirected or captured stdout gets the lines too."""

    def __init__(self) -> None:
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value) -> None:
        pass


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name``, the package's root logger configured on first
    use (a handler already there is kept, and none is added)."""
    root = logging.getLogger(ROOT)
    if not root.handlers:
        h = StdoutHandler()
        h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logging.getLogger(name)

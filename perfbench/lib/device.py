"""The card a run uses, its memory peak, and the modules a run must not load."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

import torch

# the JAX package and JAX itself, compared by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "torchrecsys_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that a run of the
    port must not have loaded. ``torchrecsys_tpu_torch`` is not
    ``torchrecsys_tpu``: the part before the first dot is compared whole."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def chips_missing(needed: int) -> str:
    """Why this machine cannot run a cell that needs ``needed`` cards, or ''."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    have = torch.cuda.device_count()
    if have < needed:
        return f"the cell needs {needed} CUDA device(s), torch.cuda.device_count() is {have}"
    return ""


def info(device: torch.device, count: int) -> Dict:
    """The ``device`` object of the result line."""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()

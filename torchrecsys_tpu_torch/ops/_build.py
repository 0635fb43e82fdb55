"""Build the hand-written CUDA kernels on first use and bind them.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``ops/build/`` (listed in ``.gitignore``), named by a hash of the source so
an edited kernel is rebuilt. Nothing builds at import: the first wrapper
call on a CUDA tensor does it, or :func:`build_all` ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# Extra flags per source: dot_topk.cu's 34 template variants compile in
# four threads (about half its build time on the card's host).
SOURCE_FLAGS = {"dot_topk.cu": ["-split-compile=4"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    """One source's build: the library path, the seconds ``nvcc`` took (0
    when the library was already built) and its ``-Xptxas -v`` report."""

    source: str
    library: str
    seconds: float
    log: str


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled on first use on a machine with "
        "the CUDA toolkit"
    )


def _target(name: str) -> str:
    src = os.path.join(CSRC, name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, BuildResult]:
    """Compile every named source (default: all of ``csrc/*.cu``) whose
    library is missing, one ``nvcc`` per source, all started together.
    Raises RuntimeError with the compiler's output if any build fails."""
    if names is None:
        names = sorted(n for n in os.listdir(CSRC) if n.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), "-o", tmp, os.path.join(CSRC, name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name].library)
            _libs[name] = lib
        return lib

"""What the harness loads: never JAX or the JAX package (compared by whole
top-level names, so ``torchrecsys_tpu_torch`` passes), and, in the plain
references, nothing of the port. Each check runs in a fresh interpreter,
so that modules other tests loaded do not count. One test runs a cell on
the card and skips where there is none."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.lib import spec

RUN_TINY = """
import sys, json
sys.path.insert(0, {root!r})
import glob, os
from perfbench.lib import spec, device
from perfbench.tests import _tiny
for name in {cells!r}:
    result, out = _tiny.run(_tiny.cell(name), seconds=0.2)
    assert result["correct"], name
for path in glob.glob(os.path.join(spec.BENCH, "metrics", "*.py")):
    spec.metric_reader(os.path.basename(path)[:-3])
import perfbench.control
print(json.dumps(device.forbidden_modules()))
"""

REFERENCE_ONLY = """
import sys, json
sys.path.insert(0, {root!r})
import perfbench.reference.plain, perfbench.reference.mf, perfbench.reference.sasrec
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0].startswith("torchrecsys"))))
"""


def _python(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_of_every_cell_loads_no_jax():
    cells = [w["name"] for w in spec.benchmark()["workloads"]]
    assert json.loads(_python(RUN_TINY.format(root=spec.ROOT, cells=cells))) == []


def test_references_import_nothing_of_the_port():
    assert json.loads(_python(REFERENCE_ONLY.format(root=spec.ROOT))) == []


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels and the benchmark's device metrics")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mf_serve_top10", "--seed",
                          str(2**31 + 11), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]

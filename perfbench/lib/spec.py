"""A cell of BENCHMARK.json resolved to its files, by name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found from the name that
``BENCHMARK.json`` gives it:

- ``perfbench/configs/<config>.json``: the sizes of a configuration, the
  plain reference it is held to (``reference``: a module of
  ``perfbench/reference/``) and how the port builds it (``port``);
- ``perfbench/traffic/<traffic>.json``: the parameters of a traffic mix
  and the generic driver that reads them (``driver``: a module of
  ``perfbench/drivers/``);
- ``perfbench/metrics/<metric>.py``: the reader of one metric, a function
  ``read(run)`` over the run's record (lib/record.py) that returns a number
  or None when the run has nothing to read;
- ``perfbench/limits/<workload>.json``: the limit of each number that the
  cell's check of ``correct`` compares.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in BENCHMARK.json; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(BENCH)  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # the BENCHMARK.json entries this cell reports
    per_layer: List[Dict[str, Any]]


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(entry: Dict[str, Any], workload: str, e2e_names: List[str]) -> bool:
    """Whether a metric entry applies to ``workload``: listed there, or (no
    ``workloads`` key) everywhere its end-to-end metric is reported."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def resolve(workload: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell named ``workload``, with its configuration, traffic and
    limits read from their files. Raises KeyError for an unknown name."""
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    entry = cfgs[w["config"]]
    config = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(BENCH, "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config, traffic,
                limits, e2e, per_layer)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read`` of ``perfbench/metrics/<name>.py``."""
    return _module(os.path.join(BENCH, "metrics", f"{name}.py"), f"perfbench_metric_{name}").read


def driver(cell: Cell):
    """The generic driver module of the cell's traffic kind."""
    kind = cell.traffic["driver"]
    return _module(os.path.join(BENCH, "drivers", f"{kind}.py"), f"perfbench_driver_{kind}")


def reference(cell: Cell):
    """The plain reference module the cell's configuration names."""
    ref = cell.config["reference"]
    return _module(os.path.join(BENCH, "reference", f"{ref}.py"), f"perfbench_reference_{ref}")

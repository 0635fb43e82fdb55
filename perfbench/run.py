"""Run one cell of the port's benchmark (BENCHMARK.json at the checkout root).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell's configuration, traffic, metrics and limits are files
of their own under perfbench/ (lib/spec.py). The run makes its inputs and
weights from ``--seed``, warms up the cell's own shapes (set-up), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics and ``breakdown``), ``device``
and ``checks`` (each compared number beside its limit), which also end
standard error. Exit codes: 0 a result was printed; 2 no such card or no
port in this checkout; 3 the traffic missed the mechanism its cell is for;
4 the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[:1] != [ROOT]:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.lib import device as devmod, spec  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def port_missing() -> str:
    """Why the port cannot be imported from this checkout, or ''."""
    try:
        import torchrecsys_tpu_torch
    except ImportError as e:
        return f"cannot import torchrecsys_tpu_torch: {e}"
    where = os.path.abspath(torchrecsys_tpu_torch.__file__)
    if not where.startswith(ROOT + os.sep):
        return f"torchrecsys_tpu_torch comes from {where}, not from this checkout"
    return ""


def run_cell(cell, seed: int, seconds: float, traced: bool, device: torch.device, t0: float):
    """Drive ``cell`` once; returns (result dict, outcome) where the outcome
    holds the driver's record, check, launch misses, the forbidden modules
    found after the window and the control's closure."""
    ctx = SimpleNamespace(seed=seed, seconds=seconds, traced=traced, device=device, t0=t0, log=log,
                          forbidden=[])
    ctx.window_closed = lambda: ctx.forbidden.extend(devmod.forbidden_modules())
    out = spec.driver(cell).run(cell, ctx, spec.reference(cell))
    out.forbidden = ctx.forbidden
    rec = out.record
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(rec)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing in {cell.name}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(out.device) if out.device else {"platform": device.type, "kind": str(device), "count": 0,
                                                "memory_peak_bytes": 0}
    result = {"correct": out.check.correct, "attempted": rec.requests if rec.kind == "serve" else rec.steps,
              "failed": 0, "metrics": metrics, "device": dev}
    if traced and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = out.check.as_dict()
    return result, out


def main(argv=None) -> int:
    args = _args(argv)
    cell = spec.resolve(args.workload)
    why = devmod.chips_missing(cell.chips) or port_missing()
    if why:
        log(f"not run: {why}")
        return 2
    torch.set_num_threads(4)
    log(f"{cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    result, out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    log(f"card: {devmod.smi_line()}")
    if out.missed:
        log("the traffic missed its mechanism: " + "; ".join(out.missed))
        return 3
    if out.forbidden:
        log(f"the run loaded {out.forbidden}: the port runs without JAX")
        return 4
    for note in out.check.notes:
        log(note)
    for line in out.check.lines():
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

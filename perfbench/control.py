"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 3

For each seed, in one process: a whole run of the cell (set-up, a short
window at the cell's own load, the check), then the control and, for a
training cell, the half-batch fault, each put in the program's place and
read by the same comparison. Prints one JSON line per seed: the sound
run's numbers (``sound``), the control's (``tf32``: the reference in TF32,
the nearest precision below float32 with TF32 off) and the fault's
(``half_batch``: the loss over half of each batch). The benchmark's own
runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[:1] != [ROOT]:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import device as devmod, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    why = devmod.chips_missing(cell.chips) or bench_run.port_missing()
    if why:
        bench_run.log(f"not run: {why}")
        return 2
    torch.set_num_threads(4)
    t0 = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        result, out = bench_run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t0)
        sound = {k: v["value"] for k, v in result["checks"].items()}
        line = {"workload": cell.name, "seed": seed, "correct": result["correct"], "sound": sound,
                "notes": out.check.notes, "missed": out.missed}
        line.update(out.control())
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())

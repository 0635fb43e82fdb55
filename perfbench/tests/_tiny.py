"""Cells of BENCHMARK.json cut to a size a CPU test holds: the same
configuration, traffic, limits and metric files, with fewer users, items,
interactions and rows a batch, a shorter history, and the plain CPU paths
of the port."""

import copy
import time

import torch

from perfbench import run as bench_run
from perfbench.lib import spec

SEED = 2**33 + 7  # wider than 32 bits, as the driver's seeds are


def cell(name: str, n_users: int = 300, n_items: int = 500, n_interactions: int = 6000):
    c = spec.resolve(name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["data"].update(n_users=n_users, n_items=n_items, n_interactions=n_interactions)
    if c.traffic["driver"] == "serve":
        c.traffic.update(users_per_request=16, warm_requests=2, check_requests=5)
    else:
        c.traffic["train"]["batch_size"] = 256
        if "history_len" in c.config["port"]:
            c.config["port"]["history_len"] = 8
    return c


def run(c, seed: int = SEED, seconds: float = 0.3):
    """One run of ``c`` on the CPU: (result line, outcome)."""
    return bench_run.run_cell(c, seed, seconds, False, torch.device("cpu"), time.perf_counter())

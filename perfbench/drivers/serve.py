"""Generic driver of serving traffic through the port's facade.

A traffic file of this kind gives ``users_per_request``, ``top_k``,
``exclude_seen``, ``warm_requests`` (set-up), ``check_requests`` (how many
finished requests the check samples) and ``launches`` (each launch
counter's expected count per request). One client sends requests in a
closed loop: each request is ``RecSys.predict(users, top_k)`` for distinct
users drawn uniformly from the seed, timed from the call to the raw item
ids on the host. The configuration file gives the data (lib/gen.py) and
``port`` (the facade's keywords).

The check: a sample of the finished requests, drawn from the seed, is
scored again by the plain reference from the same seeded tables, after the
port is freed. ``topk_gap`` is the widest gap by which a served item's
reference score lies below the reference's score at the same rank;
``bad_ids`` counts served ids outside the catalog, repeated in one list, or
lists of the wrong length.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.lib import counters, device as devmod, gen
from perfbench.lib.check import Check
from perfbench.lib.record import Run
from perfbench.lib.trace import Window


def _reservoir_keep(r: np.random.Generator, kept: list, size: int, seen: int, item) -> None:
    if len(kept) < size:
        kept.append(item)
    else:
        j = int(r.integers(0, seen))
        if j < size:
            kept[j] = item


def run(cell, ctx, ref):
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.models.base import padded_rows

    cfg, tr = cell.config, cell.traffic
    dev = ctx.device
    parts = {"start": time.perf_counter() - ctx.t0}
    t = time.perf_counter()
    data = gen.interactions(cfg["data"], ctx.seed)
    parts["data"] = time.perf_counter() - t
    t = time.perf_counter()
    port = dict(cfg["port"])
    rs = RecSys({"user_id": data["user_id"], "item_id": data["item_id"]}, device=dev,
                split_ratio=float(cfg["data"]["split_ratio"]), seed=ctx.seed & gen.SEED_MASK, **port)
    parts["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    vocab_u, vocab_i = gen.vocab(data["_user_ids"]), gen.vocab(data["_item_ids"])
    n_users, n_items = len(vocab_u), len(vocab_i)
    shapes = {k: (padded_rows(s.rows), s.dim) for k, s in rs.model.table_specs().items()}
    tables = ref.make_tables(shapes, gen.torch_gen(ctx.seed, 1, dev))
    rs.load_jax_tables({k: v.cpu().numpy() for k, v in tables.items()})
    parts["tables"] = time.perf_counter() - t
    del data

    u, k = int(tr["users_per_request"]), int(tr["top_k"])
    kw = dict(top_k=k, exclude_seen=bool(tr["exclude_seen"]))
    warm = gen.np_rng(ctx.seed, 3)
    for _ in range(int(tr["warm_requests"])):
        rs.predict(vocab_u[gen.request_users(warm, n_users, u)], **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t0
    parts["warm"] = setup_s - sum(parts.values())
    ctx.log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    names = list(tr["launches"])
    before = counters.read(names)
    users_r, keep_r = gen.np_rng(ctx.seed, 2), gen.np_rng(ctx.seed, 4)
    kept: list = []
    lat = []
    with Window(ctx.traced, dev) as win:
        end = win.start + ctx.seconds
        while True:
            rows = gen.request_users(users_r, n_users, u)
            raw = vocab_u[rows]
            t = time.perf_counter()
            out = rs.predict(raw, **kw)
            done = time.perf_counter()
            lat.append(done - t)
            _reservoir_keep(keep_r, kept, int(tr["check_requests"]), len(lat), (rows, out))
            if done >= end:
                break
        win.close()
    after = counters.read(names)
    record = Run("serve", cfg, tr, setup_s=setup_s, window_s=win.seconds, latencies=lat,
                 users_per_request=u, launches={n: after[n] - before[n] for n in names},
                 shapes={"U": u, "N": n_items, "D": int(port["n_factors"]), "k": k,
                         "dtype": cfg["dtype"]},
                 trace=win.trace)
    ctx.log(f"launches in the window: {record.launches} over {record.requests} requests")
    missed = counters.misses(tr["launches"], before, after, record.requests)
    dev_info = devmod.info(dev, cell.chips) if dev.type == "cuda" else None
    ctx.window_closed()

    del rs, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    check = Check(cell.limits)
    gap, bad = judge(ref, tables, vocab_i, kept, n_items, k)
    check.add("topk_gap", gap)
    check.add("bad_ids", bad)
    check.notes.append(f"compared {len(kept)} requests, {sum(len(r) for r, _ in kept)} user lists")

    def control():
        """The control's numbers: the reference in TF32 in the program's
        place, on the same sampled requests."""
        lists = []
        for rows, _ in kept:
            with torch.no_grad():
                s = ref.catalog_scores(tables, torch.as_tensor(rows, device=dev), n_items, low=True)
                lists.append((rows, vocab_i[ref.topk(s, k)[1].cpu().numpy()]))
        gap_c, bad_c = judge(ref, tables, vocab_i, lists, n_items, k)
        return {"tf32": {"topk_gap": gap_c, "bad_ids": bad_c}}

    return SimpleNamespace(record=record, check=check, device=dev_info, missed=missed, control=control)


def judge(ref, tables, vocab_i, kept, n_items: int, k: int):
    """(widest rank gap, bad ids) of the served lists in ``kept`` against
    the reference's scores."""
    dev = tables["item"].device
    gap, bad = 0.0, 0
    for rows, out in kept:
        out = np.asarray(out)
        if out.ndim != 2 or out.shape != (len(rows), k):
            bad += len(rows)
            continue
        got = gen.rows_of(vocab_i, out.astype(np.int64).reshape(-1)).reshape(out.shape)
        bad += int((got < 0).sum())
        bad += sum(k - len(np.unique(r)) for r in got)
        with torch.no_grad():
            s = ref.catalog_scores(tables, torch.as_tensor(rows, device=dev), n_items)
            best = ref.topk(s, k)[0]
            served = torch.gather(s, 1, torch.as_tensor(np.maximum(got, 0), device=dev))
            gap = max(gap, float((best - served).max()))
        del s
    return gap, bad


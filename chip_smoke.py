#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. the card: its name and power limit (nvidia-smi); no card -> exit 1.
2. build every hand-written kernel from ops/csrc (nvcc, sm_90a) and print
   the build seconds and each kernel's -Xptxas -v register/shared lines.
3. each kernel against its plain torch version on the card at the serving
   shape (256 users x 1,000,000 items x 80 factors): f32, bf16 and masked
   inputs, k in {10, 128, 1024}. Random inputs: values within
   atol=1e-4 + rtol=1e-5 (f32 sums in another order over 80 products), and
   an id may differ only if the kernel's item truly scores that value
   (recomputed in f64). Exact-arithmetic inputs (small integers): ids and
   values identical.
4. the main path: RecSys over ~3M synthetic interactions (100K users, 1M
   items, one int category column), seeded tables installed through the
   JAX-table carry-over, 256-user predict batches at top_k=10, top_k=128
   and exclude_seen=True. Kernel launch counts are zeroed just before and
   read just after; every kernel must have launched. A batch of each is
   checked against the plain path, and a small catalog against the CPU.
5. per-kernel times (CUDA events over many launches) beside the bound, the
   plain version's time and one library call (torch.topk of a matmul,
   never used by the port), and predict users/s.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

U, N, D = 256, 1_000_000, 80  # serving shape: a request batch over the catalog
N_USERS, N_INTERACTIONS = 100_000, 3_000_000
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ATOL, RTOL = 1e-4, 1e-5
KERNEL_ROWS = {
    # wrapper -> (TPU kernel it replaces, k timed at the main path)
    "dot_topk_small": ("torchrecsys_tpu/ops/dot_topk.py:136", 10),
    "dot_topk_large": ("torchrecsys_tpu/ops/dot_topk.py:362", 128),
}
SOURCE = "torchrecsys_tpu_torch/ops/csrc/dot_topk.cu"
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_kernels():
    from torchrecsys_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"[build] {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for res in results.values():
        log(f"[build] {res.source}: nvcc {res.seconds:.2f} s -> {res.library}")
        name, frame = None, ""
        for line in res.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, frame = m.group(1), ""
            elif "stack frame" in line:
                frame = line.strip()
            elif "Used" in line and name:
                short = re.sub(r"^_ZN\w*?_cu_\w+?(dot_topk_\w+?kernel)", r"\1", name)
                log(f"[build]   {short[:60]}: {line.split(':', 1)[1].strip()}; {frame}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain version
# ---------------------------------------------------------------------------


def compare_topk(uv, iv, ib, mask, k, v, i, pv, pi, exact: bool):
    """Kernel (v, i) against plain (pv, pi). Returns (max |dv|, id
    mismatches); raises on a fault."""
    import torch

    check(v.shape == pv.shape and i.shape == pi.shape, f"shape {tuple(v.shape)} != {tuple(pv.shape)}")
    check(bool(torch.isfinite(v).all()), "non-finite kernel scores")
    err = float((v - pv).abs().max())
    mism = int((i != pi).sum())
    if exact:
        check(err == 0.0 and mism == 0, f"exact input: max|dv|={err}, {mism} id mismatches")
        return err, mism
    tol = ATOL + RTOL * pv.abs()
    check(bool(((v - pv).abs() <= tol).all()), f"values differ by {err}")
    check(bool((i >= 0).all() and (i < iv.shape[0]).all()), "item id out of range")
    rows = i.long()
    true = (uv.double()[:, None, :] * iv[rows].double()).sum(-1) + ib.double()[rows]
    if mask is not None:
        from torchrecsys_tpu_torch.ops.dot_topk import _NEG_INF, mask_bits_for_items

        seen = torch.stack([mask_bits_for_items(mask[r : r + 1], rows[r])[0] for r in range(rows.shape[0])])
        true = torch.where(seen, _NEG_INF, true)
    check(bool(((true - v.double()).abs() <= tol.double()).all()), "kernel ids do not score their values")
    for r in range(i.shape[0]):
        check(i[r].unique().numel() == k, f"row {r}: repeated item ids")
    return err, mism


def kernel_phase(torch):
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    seen = [rng.choice(N, size=int(rng.integers(0, 400)), replace=False) for _ in range(U)]
    mask = torch.as_tensor(dt.pack_seen_mask(seen, N), device=dev)
    errs = {name: 0.0 for name in KERNEL_ROWS}
    for exact in (False, True):
        if exact:
            uv = torch.randint(-3, 4, (U, D), generator=gen, device=dev).float()
            iv = torch.randint(-3, 4, (N, D), generator=gen, device=dev).float()
            ib = torch.randint(-3, 4, (N,), generator=gen, device=dev).float()
        else:
            uv = torch.randn(U, D, generator=gen, device=dev)
            iv = torch.randn(N, D, generator=gen, device=dev)
            ib = torch.randn(N, generator=gen, device=dev)
        for dtype, m in ((torch.float32, None), (torch.bfloat16, None), (torch.float32, mask)):
            u_, i_ = uv.to(dtype), iv.to(dtype)
            for k in (10, 128, 1024):
                fn = dt.dot_topk_small if k <= 16 else dt.dot_topk_large
                if dev.type == "cuda" and not exact and m is None:
                    splits, _, cap, smem = dt.plan(k > 16, U, N, D, dtype == torch.bfloat16, k)
                    log(f"[kernel] {fn.__name__} k={k}: {splits} catalog splits, "
                        f"{smem} B dynamic shared memory per block, pool {cap}")
                v, i = fn(u_, i_, ib, k, seen_mask=m)
                pv, pi = dt.dot_topk_plain(u_, i_, ib, k, seen_mask=m)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                err, mism = compare_topk(u_.float(), i_.float(), ib, m, k, v, i, pv, pi, exact)
                if not exact:
                    errs[fn.__name__] = max(errs[fn.__name__], err)
                log(
                    f"[kernel] {fn.__name__:15s} {'exact ' if exact else 'random'} "
                    f"{str(dtype).removeprefix('torch.'):8s} masked={m is not None!s:5s} k={k:4d}: "
                    f"max|dv|={err:.3g} id mismatches={mism}"
                )
        del uv, iv, ib
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def synthetic_interactions(seed: int = 0):
    """Block-preference interactions (bench.py:98-110): user block b prefers
    item block b, 70% on-block. Every user and item occurs at least once so
    the catalog is exactly N items; category = item % 1000, static per item."""
    r = np.random.default_rng(seed)
    n_rest = N_INTERACTIONS - N
    users = np.concatenate([r.integers(0, N_USERS, N), r.integers(0, N_USERS, n_rest)])
    users[: N_USERS] = np.arange(N_USERS)
    on_block = r.random(n_rest) < 0.7
    rand_items = r.integers(0, N, n_rest)
    block_items = ((rand_items // 8) * 8 + users[N:] % 8) % N
    items = np.concatenate([r.permutation(N), np.where(on_block, block_items, rand_items)])
    return {"user_id": users.astype(np.int64), "item_id": items.astype(np.int64), "category_id": items % 1000}


def seeded_tables(model, seed: int):
    """JAX-layout tables (padded rows, float32) from a numpy seed."""
    from torchrecsys_tpu_torch.models.base import padded_rows

    r = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(model.table_specs().items()):
        shape = (padded_rows(spec.rows), spec.dim)
        scale = 0.1 if spec.dim == 1 else 1.0 / spec.dim
        out[name] = r.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return out


def check_predict(rs, users_raw, got, top_k, exclude_seen, torch):
    """predict's raw ids against the plain path: each returned item must
    score what the plain top-k has at that rank (f64 recompute)."""
    from torchrecsys_tpu_torch.ops.dot_topk import dot_topk_plain, pack_seen_mask

    check(got.shape == (len(users_raw), top_k), f"predict shape {got.shape}")
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, transform = rs.model.linearized_catalog(rs._params(), rs.feat)
    uv, const = user_fn(rs._params(), rows)
    mask = None
    seen = None
    if exclude_seen:
        seen = rs._seen(rows.cpu().numpy())
        mask = torch.as_tensor(pack_seen_mask(seen, q.shape[0]), device=rs.device)
    pv, _ = dot_topk_plain(uv, q, ib, top_k, seen_mask=mask)
    enc = rs.store.item_encoder
    item_rows = torch.as_tensor([[enc.encode_one(x) for x in row] for row in got], device=rs.device)
    true = (uv.double()[:, None, :] * q.double()[item_rows]).sum(-1) + ib.double()[item_rows]
    check(bool(((true - pv.double()).abs() <= ATOL + RTOL * pv.double().abs()).all()), "predict disagrees with the plain path")
    if seen is not None:
        for r, s in enumerate(seen):
            check(not set(item_rows[r].tolist()) & set(s.tolist()), "exclude_seen returned a seen item")


def small_catalog_check(torch):
    """A small catalog served on the card and on the CPU from the same
    integer-valued tables (exact arithmetic): identical raw ids."""
    from torchrecsys_tpu_torch import RecSys

    r = np.random.default_rng(5)
    data = {"user_id": r.integers(0, 300, 20000), "item_id": r.integers(0, 5000, 20000)}
    data["category_id"] = data["item_id"] % 17
    rss = [RecSys(data, metadata_id_col=["category_id"], device=d) for d in (DEVICE, "cpu")]
    tables = {k: np.rint(v * 40).astype(np.float32) for k, v in seeded_tables(rss[0].model, 9).items()}
    for rs in rss:
        rs.load_jax_tables(tables)
    users = rss[0].store.user_encoder.to_list()[:64]
    for top_k, excl in ((10, False), (128, False), (10, True), (1500, False)):
        a, b = (rs.predict(users, top_k=top_k, exclude_seen=excl) for rs in rss)
        check(np.array_equal(a, b), f"small catalog top_k={top_k} exclude_seen={excl}: card != CPU")
    log("[main] small catalog: card == CPU at top_k 10/128/1500 and exclude_seen")


def main_path(torch):
    from torchrecsys_tpu_torch import RecSys
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    t0 = time.perf_counter()
    data = synthetic_interactions()
    t1 = time.perf_counter()
    rs = RecSys(data, metadata_id_col=["category_id"], n_factors=D, device=DEVICE)
    t2 = time.perf_counter()
    rs.load_jax_tables(seeded_tables(rs.model, seed=1))
    if rs.device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(rs.config["num_items"] == N and rs.config["num_users"] == N_USERS, f"config {rs.config}")
    log(
        f"[main] data {t1 - t0:.2f} s, RecSys ingest {t2 - t1:.2f} s, table carry-over "
        f"{t3 - t2:.2f} s; config {rs.config}"
    )
    all_users = rs.store.user_encoder.to_list()
    batches = [all_users[s : s + U] for s in range(0, 40 * U, U)]
    cases = (("top_k=10", 10, False), ("top_k=128", 128, False), ("exclude_seen top_k=10", 10, True))
    rates = {}
    wrappers = (dt.dot_topk_small, dt.dot_topk_large)
    for w in wrappers:
        w.launches = 0
    for label, top_k, excl in cases:
        before = {w.__name__: w.launches for w in wrappers}
        rs.predict(batches[0], top_k=top_k, exclude_seen=excl)  # warm-up
        t0 = time.perf_counter()
        outs = [rs.predict(b, top_k=top_k, exclude_seen=excl) for b in batches[1:]]
        dt_s = time.perf_counter() - t0
        rates[label] = U * len(outs) / dt_s
        grew = {n: w.launches - before[n] for n, w in ((w.__name__, w) for w in wrappers)}
        want = "dot_topk_small" if top_k <= 16 else "dot_topk_large"
        check(grew[want] == len(batches), f"{label}: {want} launched {grew[want]} times for {len(batches)} batches")
        log(f"[main] predict {label}: {len(outs)} batches of {U} users, {rates[label]:.1f} users/s, launches {grew}")
        check_predict(rs, batches[1], outs[0], top_k, excl, torch)
    launches = {w.__name__: w.launches for w in wrappers}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")
    log(f"[main] launches over the main path: {launches}")
    return rs, batches[1], launches, rates


def host_ms(torch, fn, reps: int = 10):
    """Mean ms of fn() over reps calls, synchronised (host clock)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def predict_breakdown(torch, rs, users_raw):
    """Time predict and each of its parts (the calls predict makes, in
    order), synchronised, for one batch."""
    from torchrecsys_tpu_torch.ops.dot_topk import dot_topk, pack_seen_mask_torch

    q, ib, user_fn, _ = rs._linearized()
    for top_k, excl in ((10, False), (128, False), (10, True)):
        total, _ = host_ms(torch, lambda: rs.predict(users_raw, top_k=top_k, exclude_seen=excl))
        parts = {}
        parts["encode"], rows = host_ms(
            torch, lambda: np.asarray([rs.store.user_encoder.encode_one(u) for u in users_raw])
        )
        mask = None
        if excl:
            parts["seen"], seen = host_ms(torch, lambda: rs._seen(rows))
            pos = np.repeat(np.arange(len(rows)), [len(s) for s in seen])
            parts["mask_build"], mask = host_ms(torch, lambda: pack_seen_mask_torch(
                torch.as_tensor(pos, device=rs.device),
                torch.as_tensor(np.concatenate(seen), device=rs.device), len(rows), q.shape[0],
            ))
        parts["user_vecs"], (uv, _) = host_ms(
            torch, lambda: user_fn(rs._params(), torch.as_tensor(rows, device=rs.device))
        )
        parts["kernel"], (_, ids) = host_ms(torch, lambda: dot_topk(uv, q, ib, top_k, seen_mask=mask))
        parts["to_host"], ids = host_ms(torch, lambda: ids.cpu().numpy())
        parts["decode"], _ = host_ms(torch, lambda: rs._decode_items(ids, True, False))
        log(
            f"[breakdown] predict top_k={top_k} exclude_seen={excl}: {total:.3f} ms per "
            f"{len(users_raw)}-user batch = " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        )
    cat_ms, _ = host_ms(torch, lambda: rs.model.linearized_catalog(rs._params(), rs.feat))
    log(f"[breakdown] linearized catalog rebuild (kept between calls): {cat_ms:.3f} ms")


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timing_phase(torch, rs, users_raw, launches, errs):
    from torchrecsys_tpu_torch.ops import dot_topk as dt

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, _ = rs.model.linearized_catalog(rs._params(), rs.feat)
    uv, _ = user_fn(rs._params(), rows)
    u, d = uv.shape
    n = q.shape[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 library yardstick
    rows_out = []
    saved = {w.__name__: w.launches for w in (dt.dot_topk_small, dt.dot_topk_large)}
    for name, (replaces, k) in KERNEL_ROWS.items():
        fn = getattr(dt, name)
        ms = cuda_ms(torch, lambda: fn(uv, q, ib, k))
        plain_ms = cuda_ms(torch, lambda: dt.dot_topk_plain(uv, q, ib, k), reps=5)

        def library():
            return torch.topk(torch.matmul(uv, q.T) + ib, k, dim=1)

        library_ms = cuda_ms(torch, library, reps=5)
        flops = 2.0 * u * n * d
        nbytes = (u * d + n * d) * q.element_size() + n * 4 + u * k * 8
        bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        rows_out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            "library_ms": library_ms,
        })
        log(
            f"[time] {name} (U={u}, N={n}, D={d}, k={k}, {str(q.dtype).removeprefix('torch.')}): "
            f"{ms:.4f} ms; bound {bound_ms:.4f} ms; plain {plain_ms:.4f} ms; "
            f"torch.topk(matmul) {library_ms:.4f} ms"
        )
    for w in (dt.dot_topk_small, dt.dot_topk_large):  # timing launches are not main-path launches
        w.launches = saved[w.__name__]
    return rows_out


def profile_phase(torch, rs, users_raw):
    """Device time per launch of each kernel and of the split merge, from
    torch.profiler, for K1 and K2 across k at the main-path shape."""
    from torch.profiler import ProfilerActivity, profile

    from torchrecsys_tpu_torch.ops import dot_topk as dt

    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users_raw], device=rs.device)
    q, ib, user_fn, _ = rs._linearized()
    uv, _ = user_fn(rs._params(), rows)
    for fn, k in ((dt.dot_topk_small, 10), (dt.dot_topk_large, 16), (dt.dot_topk_large, 128),
                  (dt.dot_topk_large, 1024)):
        fn(uv, q, ib, k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(uv, q, ib, k)
            torch.cuda.synchronize()
        per = {
            re.sub(r".*::(dot_topk_\w+?)(_kernel)?[<(].*", r"\1", e.key): e.device_time_total / e.count
            for e in prof.key_averages()
            if "dot_topk" in e.key
        }
        log(f"[profile] {fn.__name__} k={k}: device us per launch " + ", ".join(f"{n} {t:.1f}" for n, t in per.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    try:
        import torchrecsys_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {name}; {torch.cuda.device_count()} device(s)")
    log(smi.stdout.strip().splitlines()[0])
    t_start = time.perf_counter()
    build_kernels()
    errs = kernel_phase(torch)
    small_catalog_check(torch)
    rs, users_raw, launches, rates = main_path(torch)
    kernels = timing_phase(torch, rs, users_raw, launches, errs)
    predict_breakdown(torch, rs, users_raw)
    profile_phase(torch, rs, users_raw)
    log(f"[main] predict users/s: {json.dumps(rates)}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

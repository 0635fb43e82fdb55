#!/usr/bin/env python3
"""Time the top-k kernels #1 (dot_topk_small, k=10) and #2 (dot_topk_large,
k=128) of one tree of the port on one card, at U=256 users x N=1,000,000
items, random normal vectors; prints one JSON line of ms per call (CUDA
events over 20 calls after 3 warm-up calls).

    python3 tools/topk_timing.py ROOT F32_WIDTHS BF16_WIDTHS
    python3 tools/topk_timing.py . 80,128,160,256 80,160

ROOT is a directory holding a torchrecsys_tpu_torch package (this repo, or
another commit unpacked with ``git archive``); its kernels build into that
package's ops/build. To compare two trees, run this on each in turns
(A, B, B, A) within one session on one card.
"""

import json
import os
import sys
import time

import torch


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(root: str, f32_widths: str, bf16_widths: str) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from torchrecsys_tpu_torch.ops import _build, dot_topk as dt

    if not dt.__file__.startswith(root):
        print(f"imported {dt.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build_all(["dot_topk.cu"])
    out = {"root": root, "build_s": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda").manual_seed(7)
    u, n = 256, 1_000_000
    for dtype, widths in ((torch.float32, f32_widths), (torch.bfloat16, bf16_widths)):
        for d in [int(x) for x in widths.split(",") if x]:
            uv = torch.randn(u, d, generator=gen, device="cuda").to(dtype)
            iv = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            ib = torch.randn(n, generator=gen, device="cuda")
            for fn, k in ((dt.dot_topk_small, 10), (dt.dot_topk_large, 128)):
                out[f"{str(dtype).removeprefix('torch.')} D={d} k={k}"] = cuda_ms(lambda: fn(uv, iv, ib, k))
            del uv, iv, ib
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))

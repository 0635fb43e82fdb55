"""The chip's peaks and the operations and bytes of each measured kernel.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 989 TFLOP/s bf16 on the tensor cores; float32 work is
held to 165 TFLOP/s, the rate of 3xTF32 (495 / 3), at which the port's
kernels compute f32-accurate products on the tensor cores (plain f32 FMA
is 67 TFLOP/s, so no f32 work exceeds 165); HBM3 at 3.35 TB/s.

A kernel's bound is the larger of its operations over the peak of its
precision and its bytes over the bandwidth; each input byte counts once
and each output byte once, whatever the kernel reads again.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
_SIZE = {"float32": 4, "bfloat16": 2}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def topk_flops(u: int, n: int, d: int) -> float:
    """Kernels #1/#2: the scores of U users against N items of width D."""
    return 2.0 * u * n * d


def topk_bytes(u: int, n: int, d: int, k: int, dtype: str) -> float:
    """Item vectors, f32 item bias, user vectors and f32 user constants in;
    k (f32 score, int32 id) pairs per user out."""
    s = _SIZE[dtype]
    return n * d * s + 4.0 * n + u * d * s + 4.0 * u + 8.0 * u * k


def topk_bound_s(u: int, n: int, d: int, k: int, dtype: str) -> float:
    return bound_s(topk_flops(u, n, d), topk_bytes(u, n, d, k, dtype), dtype)


def ce_fwd_bound_s(b: int, d: int) -> float:
    """Kernel #4 on a B x B in-batch softmax of width D: the logits (2 B^2 D
    operations); h and v (B x D f32), the column bias and the ids in, the
    loss and lse out."""
    return bound_s(2.0 * b * b * d, 2.0 * b * d * 4 + 4.0 * b * 4, "float32")


def ce_bwd_bound_s(b: int, d: int) -> float:
    """Kernel #5: the recomputed logits, dh and dv (3 x 2 B^2 D operations,
    as the port's kernel table counts them); h, v, the column bias, the
    ids, lse and the cotangent in, dh, dv and the column-bias gradient
    out."""
    return bound_s(6.0 * b * b * d, 4.0 * b * d * 4 + 6.0 * b * 4, "float32")


def mf_softmax_flops_per_example(b: int, d: int) -> float:
    """Model FLOPs of one in-batch softmax row: its logits against B columns
    (2 B D) forward, twice that backward (dh and dv); recompute not counted."""
    return 6.0 * b * d


def sasrec_flops_per_example(d: int, length: int, blocks: int) -> float:
    """Model FLOPs of one SASRec training row (a positive and a negative
    scored against one history encoding), forward x 3 for the backward.
    Per block over L positions: the q, k, v projections (6 L d^2), the
    attention scores and their weighted sum over the full L x L products
    (4 L^2 d), the output projection (2 L d^2) and the two feed-forward
    layers (4 L d^2); then two item scores (4 d)."""
    per_block = 12.0 * length * d * d + 4.0 * length * length * d
    return 3.0 * (blocks * per_block + 4.0 * d)

"""Pieces the plain references share: matrix products in IEEE float32 or,
for the control, in TF32; rowwise adagrad and adam as the configurations
state them. Plain torch; nothing of the program is imported.

TF32 is computed explicitly, so that the control runs alike on the card
and on the CPU: each operand of a product (the cotangent too, backward) is
rounded to TF32's 10-bit mantissa, round to nearest even, and the product
accumulates in float32, which is what the tensor cores do with TF32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """Matrix products in IEEE float32: TF32 off for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = to_tf32(g)
        return torch.matmul(gr, br.transpose(-1, -2)), torch.matmul(ar.transpose(-1, -2), gr)


def mm(a: torch.Tensor, b: torch.Tensor, low: bool = False) -> torch.Tensor:
    """``a @ b`` in float32, or in TF32 for the control (``low``)."""
    if low:
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, sites: List[Tuple[torch.Tensor, torch.Tensor]],
                    lr: float, eps: float = 1e-10) -> None:
    """Rowwise adagrad on ``table`` (R, D) and its accumulator ``acc`` (R,),
    in place, over every gathered occurrence ``(ids, g)`` of a step: each
    occurrence moves its row by ``-lr g / sqrt(acc_before + mean(g^2) +
    eps)`` and adds ``mean(g^2)`` to the row's accumulator."""
    if not sites:
        return
    d = table.shape[1]
    ids = torch.cat([i.reshape(-1) for i, _ in sites])
    g = torch.cat([x.reshape(-1, d) for _, x in sites])
    msq = (g * g).mean(dim=1)
    scale = torch.rsqrt(acc[ids] + msq + eps)
    table.index_add_(0, ids, -lr * g * scale[:, None])
    acc.index_add_(0, ids, msq)


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict[str, Dict],
         lr: float) -> None:
    """One adam step on flat ``params`` in place (optax's update: bias
    corrected moments, eps outside the square root); ``state`` holds
    ``t``, ``m`` and ``v``."""
    t = state["t"] = state.get("t", 0) + 1
    c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
    for k, p in params.items():
        g = grads[k]
        m = state["m"][k] = ADAM_B1 * state["m"].get(k, torch.zeros_like(p)) + (1 - ADAM_B1) * g
        v = state["v"][k] = ADAM_B2 * state["v"].get(k, torch.zeros_like(p)) + (1 - ADAM_B2) * g * g
        p -= lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted paths of the tensors of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flatten(t, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}

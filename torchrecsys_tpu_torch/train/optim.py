"""Rowwise-adagrad state and the augmented table layout (port of
``torchrecsys_tpu/train/optim.py:36-47`` and :123-179).

Rowwise adagrad keeps one f32 accumulator per table row. For the length
of an epoch the accumulator rides as the last column of an augmented
``(R, D+1)`` table, so one row gather and one row scatter carry both the
parameter and its accumulator (the fused pairwise step packs these
further into 128-wide rows, ops/fused_pairwise.py; the autograd step
updates the augmented tables with :func:`apply_embedding_updates_fused`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch


def init_embedding_opt(kind: str, tables: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero accumulators, one (R,) f32 per table, on each table's device."""
    if kind != "rowwise_adagrad":
        raise ValueError(f"unknown embedding optimizer {kind!r}")
    return {
        name: {"acc": torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device)}
        for name, t in tables.items()
    }


def supports_fused_layout(kind: str, tables: Mapping[str, torch.Tensor]) -> bool:
    """The augmented layout needs f32 tables (the accumulator shares their
    dtype)."""
    return kind == "rowwise_adagrad" and all(t.dtype == torch.float32 for t in tables.values())


def augment_tables(
    tables: Mapping[str, torch.Tensor], opt_state: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """(R, D) tables + (R,) accumulators -> (R, D+1) augmented tables."""
    return {
        name: torch.cat([t, opt_state[name]["acc"][:, None]], dim=1)
        for name, t in tables.items()
    }


def split_augmented(
    aug: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Inverse of :func:`augment_tables` (contiguous copies)."""
    tables = {name: a[:, :-1].contiguous() for name, a in aug.items()}
    opt_state = {name: {"acc": a[:, -1].contiguous()} for name, a in aug.items()}
    return tables, opt_state


# [(ids (any shape), g (ids + [d]), acc_old (ids))] per gather site
FusedRowGrads = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def apply_embedding_updates_fused(
    lr: float,
    aug_tables: Mapping[str, torch.Tensor],
    grads: Mapping[str, FusedRowGrads],
    eps: float = 1e-10,
) -> None:
    """Rowwise-adagrad step on augmented tables, IN PLACE (optim.py:149-179):
    one ``index_add_`` per table of ``[-lr * g * rsqrt(acc_old + msq +
    eps), msq]`` rows, ``msq = mean(g^2)``. A row that occurs twice in one
    batch scales each occurrence by ``acc_old + its own msq``; the
    accumulator still gains every occurrence's msq."""
    for name, sites in grads.items():
        if not sites:
            continue
        aug = aug_tables[name]
        d = aug.shape[-1] - 1
        ids = torch.cat([i.reshape(-1) for i, _, _ in sites])
        g = torch.cat([gr.reshape(-1, d).float() for _, gr, _ in sites])
        acc_old = torch.cat([a.reshape(-1).float() for _, _, a in sites])
        msq = torch.mean(g * g, dim=-1)
        scale = torch.rsqrt(acc_old + msq + eps)
        upd = torch.cat([(-lr * g) * scale[:, None], msq[:, None]], dim=1)
        aug.index_add_(0, ids, upd.to(aug.dtype))

"""Rowwise-adagrad state and the augmented table layout (port of
``torchrecsys_tpu/train/optim.py:36-47`` and :123-146).

Rowwise adagrad keeps one f32 accumulator per table row. For the length
of an epoch the accumulator rides as the last column of an augmented
``(R, D+1)`` table, so one row gather and one row scatter carry both the
parameter and its accumulator (the fused pairwise step packs these
further into 128-wide rows, ops/fused_pairwise.py).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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

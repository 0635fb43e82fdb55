"""Pairwise ranking losses (port of ``torchrecsys_tpu/train/losses.py``,
:46-63 and :100-152, for the three one-negative losses).

``hinge`` is the reference's ``mean(clamp(neg - pos + margin, 0))``;
``bpr`` is ``-log sigmoid(pos - neg)``; ``logistic`` is BCE with the
positive as 1 and the negative as 0. Negatives are (B,) or (K, B); the
per-row losses average over K. ``torch.maximum`` routes half the
subgradient to each side at a tie, as ``jnp.maximum`` does, so autograd
through the hinge agrees with the fused kernel's closed form at
``diff == 0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neg2d(neg: torch.Tensor) -> torch.Tensor:
    """Normalize negatives to (K, B)."""
    return neg[None, :] if neg.dim() == 1 else neg


def hinge_per_row(pos: torch.Tensor, neg: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """clamp(neg - pos + margin, 0), mean over K draws."""
    diff = _neg2d(neg) - pos + margin
    return torch.mean(torch.maximum(diff, torch.zeros_like(diff)), dim=0)


def bpr_per_row(pos: torch.Tensor, neg: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Bayesian Personalized Ranking: -log sigmoid(pos - neg), mean over K."""
    del margin
    return -torch.mean(F.logsigmoid(pos - _neg2d(neg)), dim=0)


def logistic_per_row(pos: torch.Tensor, neg: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Pointwise logistic: BCE with positives as 1, sampled negatives as 0."""
    del margin
    return -0.5 * (F.logsigmoid(pos) + torch.mean(F.logsigmoid(-_neg2d(neg)), dim=0))


def _mean_of(per_row_fn):
    def loss(pos: torch.Tensor, neg: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
        return torch.mean(per_row_fn(pos, neg, margin))

    return loss


hinge_loss = _mean_of(hinge_per_row)
bpr_loss = _mean_of(bpr_per_row)
logistic_loss = _mean_of(logistic_per_row)

LOSS_REGISTRY = {"hinge": hinge_loss, "bpr": bpr_loss, "logistic": logistic_loss}
PER_ROW_LOSS_REGISTRY = {
    "hinge": hinge_per_row,
    "bpr": bpr_per_row,
    "logistic": logistic_per_row,
}


def get_per_row_loss(name: str):
    try:
        return PER_ROW_LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown loss {name!r}; expected one of {sorted(PER_ROW_LOSS_REGISTRY)}"
        ) from None


def get_loss(name: str):
    return _mean_of(get_per_row_loss(name))

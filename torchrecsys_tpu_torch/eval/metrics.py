"""Ranking metrics (port of ``torchrecsys_tpu/eval/metrics.py``).

- :func:`pairwise_auc`: the reference's per-batch win rate with one sampled
  negative per positive, strict ``pos > neg`` (ties count as losses).
- :func:`hit_rate`: the fraction of rows whose predicted ids meet the true
  ids.
- :func:`recall_at_k` and :func:`precision_recall_at_k` from a dense
  (B, num_items) score matrix. Where the JAX package calls ``lax.top_k``,
  the top k here are ordered by (value desc, index asc), so ties go to the
  lower item row as there (``torch.topk`` promises no order for ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_auc(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """mean(pos > neg) (metrics.py:22-24)."""
    return torch.mean((pos_scores > neg_scores).to(torch.float32))


def hit_rate(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Fraction of rows with at least one id in both ``y_true`` (B, T) and
    ``y_pred`` (B, K) (metrics.py:27-34)."""
    hits = (y_true[:, :, None] == y_pred[:, None, :]).any(dim=2).any(dim=1)
    return torch.mean(hits.to(torch.float32))


def _top_k_ids(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) column ids of the k largest scores per row, lower id first
    among equal scores."""
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


def recall_at_k(
    scores: torch.Tensor,
    true_items: torch.Tensor,
    k: int,
    true_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean over rows of the share of each row's valid true items
    (``true_items`` (B, T), ``true_mask`` (B, T)) in its top k
    (metrics.py:37-52)."""
    topk = _top_k_ids(scores, k)
    hit = (true_items[:, :, None] == topk[:, None, :]).any(dim=-1)
    if true_mask is None:
        true_mask = torch.ones_like(true_items, dtype=torch.bool)
    m = true_mask.to(torch.float32)
    per_row = torch.sum(hit.to(torch.float32) * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)
    return torch.mean(per_row)


def precision_recall_at_k(
    scores: torch.Tensor,
    true_items: torch.Tensor,
    k: int,
    true_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision@k and recall@k from a dense score matrix
    (metrics.py:55-68)."""
    topk = _top_k_ids(scores, k)
    if true_mask is None:
        true_mask = torch.ones_like(true_items, dtype=torch.bool)
    hit = (true_items[:, :, None] == topk[:, None, :]) & true_mask[:, :, None]
    hits_per_row = torch.sum(hit.any(dim=1).to(torch.float32), dim=1)
    n_true = torch.clamp_min(torch.sum(true_mask.to(torch.float32), dim=1), 1.0)
    return torch.mean(hits_per_row / k), torch.mean(hits_per_row / n_true)

"""Side-feature tables and per-batch attachment (port of
``torchrecsys_tpu/data/features.py:23-33`` and of the metadata part of
``Trainer.feature_tables``, ``train/trainer.py:904-910``).

``feat`` is a (possibly empty) dict holding
  meta_ids  (num_items, F, W) int64    meta_mask (num_items, F, W) bool
as tensors on the model's device. Serving builds it with
:func:`feature_tables`, so no trainer is needed to serve.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torchrecsys_tpu_torch.data.interactions import InteractionStore

Features = Dict[str, torch.Tensor]


def feature_tables(store: InteractionStore, device: torch.device) -> Features:
    """Device-resident item-metadata tables of ``store`` (empty dict when
    the store has no metadata)."""
    feat: Features = {}
    if store.metadata.num_features > 0:
        feat["meta_ids"] = torch.as_tensor(store.metadata.ids, device=device).long()
        feat["meta_mask"] = torch.as_tensor(store.metadata.mask, device=device)
    return feat


def attach_features(
    side: Dict[str, torch.Tensor], feat: Optional[Features]
) -> Dict[str, torch.Tensor]:
    """Gather per-item feature rows into a batch side (in place)."""
    if feat and "meta_ids" in feat and feat["meta_ids"].shape[1] > 0:
        side["meta_ids"] = feat["meta_ids"][side["item_id"]]
        side["meta_mask"] = feat["meta_mask"][side["item_id"]]
    return side

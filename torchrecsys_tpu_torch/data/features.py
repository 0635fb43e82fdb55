"""Side-feature tables and per-batch attachment (port of
``torchrecsys_tpu/data/features.py:23-33`` and of the metadata and history
parts of ``Trainer.feature_tables``, ``train/trainer.py:904-914``).

``feat`` is a (possibly empty) dict holding any of
  meta_ids  (num_items, F, W) int64    meta_mask (num_items, F, W) bool
  hist_ids  (num_users, L)    int64    hist_mask (num_users, L)    bool
as tensors on the model's device. Serving builds it with
:func:`feature_tables`, so no trainer is needed to serve.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torchrecsys_tpu_torch.data.interactions import InteractionStore

Features = Dict[str, torch.Tensor]


def feature_tables(store: InteractionStore, model, device: torch.device) -> Features:
    """Device-resident item-metadata tables of ``store`` (none when the
    store has no metadata) and, for a model that ``needs_history`` (the
    sequence models), each user's window of their last
    ``model.cfg.history_len`` train items (``store.user_history``)."""
    feat: Features = {}
    if store.metadata.num_features > 0:
        feat["meta_ids"] = torch.as_tensor(store.metadata.ids, device=device).long()
        feat["meta_mask"] = torch.as_tensor(store.metadata.mask, device=device)
    if model.needs_history:
        ids, mask = store.user_history(model.cfg.history_len)
        feat["hist_ids"] = torch.as_tensor(ids, device=device).long()
        feat["hist_mask"] = torch.as_tensor(mask, device=device)
    return feat


def attach_features(
    side: Dict[str, torch.Tensor], feat: Optional[Features]
) -> Dict[str, torch.Tensor]:
    """Gather per-item and per-user feature rows into a batch side (in
    place)."""
    if not feat:
        return side
    if "meta_ids" in feat and feat["meta_ids"].shape[1] > 0:
        side["meta_ids"] = feat["meta_ids"][side["item_id"]]
        side["meta_mask"] = feat["meta_mask"][side["item_id"]]
    if "hist_ids" in feat:
        side["hist_ids"] = feat["hist_ids"][side["user_id"]]
        side["hist_mask"] = feat["hist_mask"][side["user_id"]]
    return side

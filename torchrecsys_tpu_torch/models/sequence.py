"""What the sequence models share (ports of the common parts of
``torchrecsys_tpu/models/lstm.py`` and ``models/sasrec.py``, which HSTU,
models/hstu.py, shares too).

A sequence model encodes each user's last ``history_len`` train items (the
``(num_users, L)`` tables ``hist_ids``/``hist_mask`` of
data/features.py, gathered by user id) into a vector ``h_u`` and scores
``<h_u, item> + b_item``. The subclass supplies the encoder
(``_encode(dense, hist_emb (B, L, D), hist_mask (B, L)) -> (B, D)``).

Leakage control differs on three paths, as in the JAX package:

- a generic side (one row per (user, candidate): ``pair_vectors``, the
  chunked predict scorer) hides the scored candidate from its own history;
- a paired side (``side["_pair_b"] = B``: positives, then the negative
  blocks of the same B users, train/trainer.py::_paired_side) encodes each
  pair's history once with the POSITIVE hidden and scores every block
  against it, so a negative does not prune its own history occurrence;
- serving through :meth:`linearized_catalog` encodes the history unmasked:
  the history is the user's past and the candidates are ranked for the
  future, which also makes ``h_u`` candidate-independent.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import torch

from torchrecsys_tpu_torch.models.base import Batch, RecModel, State, TableSpec


class SequenceModel(RecModel):
    needs_history = True
    supports_linearized_catalog = True
    supports_sampled_softmax = True

    def table_specs(self) -> Dict[str, TableSpec]:
        d = self.cfg.n_factors
        s = self.schema
        return {
            "item": TableSpec(s.num_items, d, "scaled"),
            "item_bias": TableSpec(s.num_items, 1, "zero"),
        }

    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        hist_ids = batch["hist_ids"]
        b = batch.get("_pair_b")
        if b is not None:
            # paired side: every block carries the same B users' histories:
            # gather (and scatter) each pair's history rows once
            hist_ids = hist_ids[:b]
        return {
            "item": ("item", batch["item_id"]),
            "item_bias": ("item_bias", batch["item_id"]),
            "hist": ("item", hist_ids),  # (B, L) -> (B, L, D)
        }

    @abc.abstractmethod
    def _encode(self, dense: Any, hist_emb: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) history rows and (B, L) mask -> (B, D) user vectors."""

    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        cd = self.compute_dtype
        item = rows["item"].to(cd)  # ((1+K)B or B, D)
        b = batch.get("_pair_b")
        if b is None:
            mask = batch["hist_mask"] & (batch["hist_ids"] != batch["item_id"][:, None])
            h = self._encode(dense, rows["hist"], mask)
        else:
            mask = batch["hist_mask"][:b] & (batch["hist_ids"][:b] != batch["item_id"][:b, None])
            h = self._encode(dense, rows["hist"], mask).repeat(item.shape[0] // b, 1)
        score = torch.sum(h * item, dim=-1) + rows["item_bias"][:, 0].to(cd)
        return score.float(), state

    def pair_vectors(self, dense, state, rows, batch, train):
        """score(i, j) = h_i · item_j + b_item_j, h the history encoding
        with the row's own candidate hidden (the generic-side rule)."""
        cd = self.compute_dtype
        mask = batch["hist_mask"] & (batch["hist_ids"] != batch["item_id"][:, None])
        h = self._encode(dense, rows["hist"], mask)
        return h, rows["item"].to(cd), rows["item_bias"][:, 0].to(cd), state

    def encode_users(self, params, feat, user_ids: torch.Tensor) -> torch.Tensor:
        """(U,) user rows -> (U, D) encodings of their unmasked histories."""
        h_ids = feat["hist_ids"][user_ids]
        h_mask = feat["hist_mask"][user_ids]
        return self._encode(params["dense"], params["tables"]["item"][h_ids], h_mask)

    def linearized_catalog(self, params, feat):
        """Encode-once full-catalog predict for the fused score + top-k
        kernels: each user's history encoded once, unmasked (see the module
        docstring). Under bf16 compute the vectors are bf16; the biases and
        scores stay f32."""
        if not feat or "hist_ids" not in feat:
            raise ValueError(
                f"{self.name} full-catalog predict needs the user-history feature "
                "tables (data/features.py::feature_tables -> hist_ids/hist_mask)"
            )
        n = self.schema.num_items
        tables = params["tables"]
        vd = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else torch.float32
        item_vecs = tables["item"][:n].to(vd)
        item_bias = tables["item_bias"][:n, 0].float()

        def user_fn(params_, user_ids):
            h = self.encode_users(params_, feat, user_ids)
            return h.to(vd), torch.zeros((user_ids.shape[0],), dtype=torch.float32, device=h.device)

        def transform(raw, user_const):
            return raw

        return item_vecs, item_bias, user_fn, transform

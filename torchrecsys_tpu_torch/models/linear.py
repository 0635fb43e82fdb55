"""LightFM-style linear factorization model (port of
``torchrecsys_tpu/models/linear.py:29-130``).

``score = <u, i + sum_f m_f> + b_u + b_i``: each metadata feature adds the
masked sum of its ids' embeddings into the item vector.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from torchrecsys_tpu_torch.models.base import (
    Batch,
    RecModel,
    State,
    TableSpec,
    masked_sum,
)


class LinearModel(RecModel):
    name = "linear"
    supports_linearized_catalog = True
    user_gather_sites = frozenset({"user", "user_bias"})
    # score = <u, i> + b_u + b_i: the bias tables ride the packed side rows
    pairwise_pack = {"user": ("user", "user_bias"), "item": ("item", "item_bias")}
    # every item-side row's gradient (item vector and each metadata slot)
    # is g * u (linear.py:31-45)
    pairwise_meta = True
    pairwise_fm_fields = False
    pairwise_sigmoid = False
    supports_sampled_softmax = True

    def table_specs(self) -> Dict[str, TableSpec]:
        d = self.cfg.n_factors
        s = self.schema
        specs = {
            "user": TableSpec(s.num_users, d, "scaled"),
            "item": TableSpec(s.num_items, d, "scaled"),
            "user_bias": TableSpec(s.num_users, 1, "zero"),
            "item_bias": TableSpec(s.num_items, 1, "zero"),
        }
        for fname, vocab in zip(s.metadata_names, s.metadata_vocab_sizes):
            specs[f"meta_{fname}"] = TableSpec(max(vocab, 1), d, "scaled")
        return specs

    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        g = {
            "user": ("user", batch["user_id"]),
            "item": ("item", batch["item_id"]),
            "user_bias": ("user_bias", batch["user_id"]),
            "item_bias": ("item_bias", batch["item_id"]),
        }
        g.update(self._meta_gathers(batch))
        return g

    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        cd = self.compute_dtype
        u = rows["user"].to(cd)
        i = rows["item"].to(cd)
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            m = rows[f"meta:{fname}"].to(cd)  # (B, W, D)
            i = i + masked_sum(m, batch["meta_mask"][:, f, :])
        dot = torch.sum(u * i, dim=-1)
        score = dot + rows["user_bias"][:, 0].to(cd) + rows["item_bias"][:, 0].to(cd)
        return score.float(), state

    def pair_vectors(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, State]:
        """score(i, j) = u_i . (item_j + sum_f meta_j) + b_item_j (linear.py:
        93-103). The user bias is constant along a row, so the softmax drops
        it and its table gets no gradient."""
        cd = self.compute_dtype
        u = rows["user"].to(cd)
        i = rows["item"].to(cd)
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            m = rows[f"meta:{fname}"].to(cd)
            i = i + masked_sum(m, batch["meta_mask"][:, f, :])
        return u, i, rows["item_bias"][:, 0].to(cd), state

    def linearized_catalog(self, params, feat):
        """score = <u, i + sum_f m_f> + b_i + b_u, factored for the fused
        score + top-k kernels (linear.py:105-130). With bf16 compute the
        factor vectors stay bf16 (half the item stream); biases and score
        accumulation stay f32."""
        tables = params["tables"]
        n = self.schema.num_items
        vd = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else torch.float32
        q = tables["item"][:n].float()
        for msum in self._catalog_meta_sums(tables, feat):
            q = q + msum.float()
        q = q.to(vd)
        item_bias = tables["item_bias"][:n, 0].float()

        def user_fn(params_, user_ids):
            tables_ = params_["tables"]
            return (
                tables_["user"][user_ids].to(vd),
                tables_["user_bias"][user_ids][:, 0].float(),
            )

        def transform(raw, user_const):
            return raw + user_const[:, None]

        return q, item_bias, user_fn, transform

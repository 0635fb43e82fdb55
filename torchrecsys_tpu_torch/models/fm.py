"""Second-order Factorization Machine over {user, item, metadata...} fields
(port of ``torchrecsys_tpu/models/fm.py``).

Each field has a factor vector (``user``, ``item``, one masked sum per
metadata feature) and a width-1 linear term. The score is the pairwise
term ``0.5 * sum((sum_f v)^2 - sum_f v^2)`` plus the summed linear terms,
then, with ``ModelConfig.fm_sigmoid`` (the default, the reference's
fm.py:99), a sigmoid. Multi-hot metadata fields are the masked SUM of their
ids' vectors.

With the two fields {user, item} the pairwise term is exactly ``u.i`` and
the linear terms ride the packed bias lanes, so FM without metadata trains
through the same fused pairwise step as Linear, with the sigmoid chain
(``pairwise_pack``). With metadata the item side is the composite
``q = i + sum_f c_f``: the fused step's score is exact once the bias lane
takes the per-item constant ``0.5(|q|^2 - |i|^2 - sum_f |c_f|^2)`` plus the
masked linear-metadata sums, and the item-side gradients, which differ per
field, are formed outside the row math (ops/fused_pairwise.py,
``fused_pairwise_step_meta(..., fm=True)``).
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


class FMModel(RecModel):
    name = "fm"
    user_gather_sites = frozenset({"user", "linear_user"})
    supports_linearized_catalog = True
    pairwise_pack = {"user": ("user", "linear_user"), "item": ("item", "linear_item")}
    pairwise_meta = True
    pairwise_fm_fields = True
    supports_sampled_softmax = True

    @property
    def pairwise_sigmoid(self) -> bool:
        return self.cfg.fm_sigmoid

    def table_specs(self) -> Dict[str, TableSpec]:
        k = self.cfg.n_factors
        s = self.schema
        specs = {
            "user": TableSpec(s.num_users, k, "scaled"),
            "item": TableSpec(s.num_items, k, "scaled"),
            "linear_user": TableSpec(s.num_users, 1, "scaled"),
            "linear_item": TableSpec(s.num_items, 1, "scaled"),
        }
        for fname, vocab in zip(s.metadata_names, s.metadata_vocab_sizes):
            specs[f"meta_{fname}"] = TableSpec(max(vocab, 1), k, "scaled")
            specs[f"linear_meta_{fname}"] = TableSpec(max(vocab, 1), 1, "scaled")
        return specs

    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        g = {
            "user": ("user", batch["user_id"]),
            "item": ("item", batch["item_id"]),
            "linear_user": ("linear_user", batch["user_id"]),
            "linear_item": ("linear_item", batch["item_id"]),
        }
        g.update(self._meta_gathers(batch))
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            g[f"linear_meta:{fname}"] = (f"linear_meta_{fname}", batch["meta_ids"][:, f, :])
        return g

    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        """The field stack (fm.py:83-97) and the optional sigmoid (:99)."""
        cd = self.compute_dtype
        fields = [rows["user"].to(cd), rows["item"].to(cd)]
        linear = rows["linear_user"][:, 0].to(cd) + rows["linear_item"][:, 0].to(cd)
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            mask = batch["meta_mask"][:, f, :]
            fields.append(masked_sum(rows[f"meta:{fname}"].to(cd), mask))
            linear = linear + masked_sum(rows[f"linear_meta:{fname}"].to(cd), mask)[:, 0]
        v = torch.stack(fields, dim=1)  # (B, n_fields, k)
        sum_v = torch.sum(v, dim=1)
        sum_v2 = torch.sum(v * v, dim=1)
        score = 0.5 * torch.sum(sum_v * sum_v - sum_v2, dim=-1) + linear
        if self.cfg.fm_sigmoid:
            score = torch.sigmoid(score)
        return score.float(), state

    def pair_vectors(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, State]:
        """The collapse of :meth:`linearized_catalog`: with the item-side
        composite ``q_j = v_item + sum v_meta``, score(i, j) = u_i . q_j +
        [0.5(|q_j|^2 - |v_item|^2 - sum |v_meta|^2) + w_item_j + sum w_meta_j]
        (+ w_user_i, constant along a row: dropped). Refused under the
        sigmoid: a softmax over (0, 1)-squashed scores saturates."""
        if self.cfg.fm_sigmoid:
            raise ValueError(
                "loss='sampled_softmax' with net_type='fm' requires "
                "ModelConfig.fm_sigmoid=False (softmax over "
                "sigmoid-squashed scores saturates; the sigmoid exists "
                "only for reference score parity, fm.py:99)"
            )
        cd = self.compute_dtype
        u = rows["user"].to(cd)
        i = rows["item"].to(cd)
        q = i
        sq_sum = torch.sum(i * i, dim=-1)
        vb = rows["linear_item"][:, 0].to(cd)
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            mask = batch["meta_mask"][:, f, :]
            msum = masked_sum(rows[f"meta:{fname}"].to(cd), mask)
            q = q + msum
            sq_sum = sq_sum + torch.sum(msum * msum, dim=-1)
            vb = vb + masked_sum(rows[f"linear_meta:{fname}"].to(cd), mask)[:, 0]
        vb = vb + 0.5 * (torch.sum(q * q, dim=-1) - sq_sum)
        return u, q, vb, state

    def linearized_catalog(self, params, feat):
        """``score = transform(u.q + item_const + w_item + sum w_meta, w_u)``
        with ``q = v_i + sum_f v_mf`` and ``item_const = 0.5(|q|^2 - |v_i|^2
        - sum |v_mf|^2)``: a monotonic transform (the sigmoid, or none) of a
        bilinear score, so the fused score + top-k kernels apply. With bf16
        compute q and the user vectors go to the kernels in bf16; the item
        bias and the user constant stay f32."""
        tables = params["tables"]
        n = self.schema.num_items
        i = tables["item"][:n].float()
        q = i
        sq_sum = torch.sum(i * i, dim=-1)
        lin_item = tables["linear_item"][:n, 0].float()
        for msum in self._catalog_meta_sums(tables, feat):
            msum = msum.float()
            q = q + msum
            sq_sum = sq_sum + torch.sum(msum * msum, dim=-1)
        if feat and "meta_ids" in feat and feat["meta_ids"].shape[1] > 0:
            for f, fname in enumerate(self.schema.metadata_names):
                lemb = tables[f"linear_meta_{fname}"][feat["meta_ids"][:, f, :]].float()
                lin_item = lin_item + masked_sum(lemb, feat["meta_mask"][:, f, :])[:, 0]
        item_bias = 0.5 * (torch.sum(q * q, dim=-1) - sq_sum) + lin_item
        vd = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else torch.float32
        q = q.to(vd)
        sigmoid = self.cfg.fm_sigmoid

        def user_fn(params_, user_ids):
            tables_ = params_["tables"]
            return (
                tables_["user"][user_ids].to(vd),
                tables_["linear_user"][user_ids][:, 0].float(),
            )

        def transform(raw, user_const):
            s = raw + user_const[:, None]
            return torch.sigmoid(s) if sigmoid else s

        return q, item_bias, user_fn, transform

"""Neural collaborative filtering (port of ``torchrecsys_tpu/models/neucf.py``).

A GMF half (the elementwise product of dedicated user and item vectors)
beside an MLP tower over ``[u_mlp, i_mlp, masked means of each metadata
feature's embeddings]`` (relu after every hidden layer), joined by one
output layer over ``[gmf, tower]`` (He et al. 2017). Each side's GMF and
MLP vectors are packed into one ``(rows, 2d)`` table, each half drawn
like a d-wide table (``init_scale = 1/d``). The score does not factorize
into user and item vectors, so there is no kernel: training takes the
autograd pairwise step, ``loss="sampled_softmax"`` raises, and predict
and ranking metrics take the chunked scorer
(eval/predict.py::full_catalog_topk). ``use_amp`` computes in bf16.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from torchrecsys_tpu_torch.models.base import (
    Batch,
    RecModel,
    State,
    TableSpec,
    masked_mean,
    uniform_linear_init,
)


class NeuCFModel(RecModel):
    name = "neucf"
    user_gather_sites = frozenset({"user"})

    def table_specs(self) -> Dict[str, TableSpec]:
        d = self.cfg.n_factors
        s = self.schema
        specs = {
            "user": TableSpec(s.num_users, 2 * d, "scaled", init_scale=1.0 / d),
            "item": TableSpec(s.num_items, 2 * d, "scaled", init_scale=1.0 / d),
        }
        for fname, vocab in zip(s.metadata_names, s.metadata_vocab_sizes):
            specs[f"meta_{fname}"] = TableSpec(max(vocab, 1), d, "scaled")
        return specs

    def _mlp_input_width(self) -> int:
        return self.cfg.n_factors * (2 + len(self.schema.metadata_names))

    def init_dense(self, generator: torch.Generator) -> Any:
        """``{"layers": [{"w" (fan_in, fan_out), "b"}], "out": {"w" (d +
        last width, 1), "b"}}`` (neucf.py:58-67)."""
        widths = [self._mlp_input_width(), *self.cfg.neucf_hidden_layers]
        dt = self.param_dtype
        layers: List[Dict[str, torch.Tensor]] = [
            uniform_linear_init(generator, fan_in, fan_out, dt)
            for fan_in, fan_out in zip(widths[:-1], widths[1:])
        ]
        out = uniform_linear_init(generator, self.cfg.n_factors + widths[-1], 1, dt)
        return {"layers": layers, "out": out}

    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        g = {
            "user": ("user", batch["user_id"]),
            "item": ("item", batch["item_id"]),
        }
        g.update(self._meta_gathers(batch))
        return g

    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        cd = self.compute_dtype
        d = self.cfg.n_factors
        u = rows["user"].to(cd)
        i = rows["item"].to(cd)
        gmf = u[:, :d] * i[:, :d]
        parts = [u[:, d:], i[:, d:]]
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            m = rows[f"meta:{fname}"].to(cd)
            parts.append(masked_mean(m, batch["meta_mask"][:, f, :]))
        x = torch.cat(parts, dim=-1)
        for layer in dense["layers"]:
            x = torch.relu(x @ layer["w"].to(cd) + layer["b"].to(cd))
        fused = torch.cat([gmf, x], dim=-1)
        score = fused @ dense["out"]["w"].to(cd) + dense["out"]["b"].to(cd)
        return score[:, 0].float(), state

"""LSTM user-history encoder (port of ``torchrecsys_tpu/models/lstm.py``).

One fused gate matmul ``[x, h] (2d) -> 4d`` per step, gates in the order
i, f, g, o, then a ``d -> d`` projection of the final hidden state. A
masked step carries the state through (``h * (1 - m) + h_new * m``), so
left-padded and interleaved masks encode like a packed sequence. The
recurrence is the L explicit steps of the JAX package's ``lax.scan``:
cuDNN's LSTM cannot carry the state through masked steps. Tables, gathers,
scoring and serving: models/sequence.py.
"""

from __future__ import annotations

from typing import Any

import torch

from torchrecsys_tpu_torch.models.base import uniform_linear_init
from torchrecsys_tpu_torch.models.sequence import SequenceModel


class LSTMModel(SequenceModel):
    name = "lstm"

    def init_dense(self, generator: torch.Generator) -> Any:
        d = self.cfg.n_factors
        return {
            "lstm": uniform_linear_init(generator, 2 * d, 4 * d, self.param_dtype),
            "proj": uniform_linear_init(generator, d, d, self.param_dtype),
        }

    def _encode(self, dense: Any, hist_emb: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) history and (B, L) mask -> (B, D) projected final state."""
        cd = self.compute_dtype
        w = dense["lstm"]["w"].to(cd)
        b = dense["lstm"]["b"].to(cd)
        x_all = hist_emb.to(cd)
        m_all = hist_mask.to(cd)
        h = c = torch.zeros((x_all.shape[0], self.cfg.n_factors), dtype=cd, device=x_all.device)
        for t in range(x_all.shape[1]):
            z = torch.cat([x_all[:, t], h], dim=-1) @ w + b
            i, f, g, o = torch.chunk(z, 4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = m_all[:, t, None]
            h, c = h * (1 - m) + h_new * m, c * (1 - m) + c_new * m
        return h @ dense["proj"]["w"].to(cd) + dense["proj"]["b"].to(cd)

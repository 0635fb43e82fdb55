"""HSTU history encoder: the Hierarchical Sequential Transduction Unit of
generative recommenders (Zhai et al., ICML 2024, arXiv:2402.17152, and
its open code, github.com/facebookresearch/generative-recommenders). It
has no counterpart in the JAX package.

With x of shape (B, L, d), ``hstu_heads`` heads h and dqk = dv = d / h,
the input is x = (sqrt(d) e + p) * valid (e the history's item rows, p
the learned positions); each of ``hstu_blocks`` blocks is

    z = LN(x)                                 (no affine parameters)
    u, v, q, k = split(SiLU(z W_uvqk))        (W_uvqk (d, 4d), no bias)
    a = SiLU(q k^T + R) / L * M               (per head; R[i, j] = w[j - i + L - 1])
    y = (LN(concat_h(a v)) * u) W_o + b_o
    x = (x + y) * valid

with M[b, i, j] = [j <= i] and valid[b, j], the division by the padded
length L (no softmax, no 1/sqrt(dqk)), and w the block's 2L - 1 relative
position weights, shared by the heads. The user vector is the state at
the last valid position over its L2 norm (the published
``user_embedding_norm = "l2_norm"``): h / max(|h|, 1e-6), so an empty
history encodes to zeros. Both norms a block (eps 1e-6) go through
ops/layer_norm.py: kernel #8 on CUDA tensors, the plain formula on the
CPU. The attention goes through ops/hstu_attention.py
(:func:`~torchrecsys_tpu_torch.ops.hstu_attention.pointwise_attention`):
on CUDA tensors kernel pair #9 (at any window and head width), whose
forward writes only o and whose
backward recomputes the scores on chip from q, k, w and the (B, L) mask, so
autograd keeps no (B, h, L, L) tensor and the forward runs once (at the
benchmark's B = 8192, L = 200, 8 blocks of 2 heads, the plain version's
saved SiLU inputs and weights would take ~42 GB beside ~43 GB of the rest,
more than the card has); on the CPU the plain torch version
(``pointwise_attention_plain``) under autograd.

Departures from the published model: no time-bucket bias rab^t (the
port's interactions carry no timestamps), no dropout (published
``linear_dropout_rate`` 0.2), the shared scorer ``<h, q_i> + b_i`` of
models/sequence.py (an item bias; no item L2 norm or temperature, which
belong to HSTU's sampled softmax loss), and one training row per
interaction with the user's window. Tables, gathers, scoring and serving:
models/sequence.py.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from torchrecsys_tpu_torch.models.sequence import SequenceModel
from torchrecsys_tpu_torch.ops.hstu_attention import pointwise_attention
from torchrecsys_tpu_torch.ops.layer_norm import layer_norm_unit
from torchrecsys_tpu_torch.utils.profiling import annotate, count

_LN_EPS = 1e-6
_NORM_EPS = 1e-6  # the user vector's L2 norm is clamped here
_INIT_STD = 0.02  # W_uvqk and the relative position weights (the published init)


def relative_bias(w: torch.Tensor, length: int) -> torch.Tensor:
    """(L, L) R[i, j] = w[j - i + L - 1] from the first 2L - 1 weights, by
    the published code's pad-repeat-reshape (views and one copy, so its
    gradient is a fixed-order sum)."""
    n = length
    t = F.pad(w[: 2 * n - 1], [0, n]).repeat(n)[:-n].reshape(n, 3 * n - 2)
    return t[:, n - 1: 2 * n - 1]


class HSTUModel(SequenceModel):
    name = "hstu"

    def __init__(self, schema, cfg) -> None:
        super().__init__(schema, cfg)
        if cfg.n_factors % cfg.hstu_heads:
            raise ValueError(
                f"hstu: n_factors={cfg.n_factors} must be divisible by hstu_heads={cfg.hstu_heads}"
            )

    def init_dense(self, generator: torch.Generator) -> Any:
        """``{"blocks": [{"uvqk": {"w" (d, 4d) ~ N(0, 0.02^2)}, "o": {"w"
        (d, d) xavier-uniform, "b" 0}, "rab_pos" (2L - 1,) ~ N(0,
        0.02^2)}], "pos" (history_len, d) ~ N(0, 1/d^2)}``: the published
        initialisation, ``pos`` as SASRec's."""
        d, length = self.cfg.n_factors, self.cfg.history_len
        dev, dt = generator.device, self.param_dtype
        bound = math.sqrt(6.0 / (d + d))
        blocks = []
        for _ in range(self.cfg.hstu_blocks):
            uvqk = torch.randn((d, 4 * d), generator=generator, device=dev) * _INIT_STD
            o_w = torch.rand((d, d), generator=generator, device=dev) * (2 * bound) - bound
            rab = torch.randn((2 * length - 1,), generator=generator, device=dev) * _INIT_STD
            blocks.append({
                "uvqk": {"w": uvqk.to(dt)},
                "o": {"w": o_w.to(dt), "b": torch.zeros((d,), dtype=dt, device=dev)},
                "rab_pos": rab.to(dt),
            })
        pos = (torch.randn((length, d), generator=generator, device=dev) * (1.0 / d)).to(dt)
        return {"blocks": blocks, "pos": pos}

    def _encode(self, dense: Any, hist_emb: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) history and (B, L) mask -> (B, D): the L2-normalised
        state at each row's last valid position."""
        with annotate("hstu.encode"):
            count("hstu.encodes")
            x = self.states(dense, hist_emb, hist_mask)
            bsz, l, d = x.shape
            pos_idx = torch.arange(l, device=x.device)
            last = torch.max(torch.where(hist_mask, pos_idx[None, :], -1), dim=1).values
            h_last = torch.gather(x, 1, last.clamp_min(0)[:, None, None].expand(bsz, 1, d))[:, 0]
            h = torch.where((last >= 0)[:, None], h_last, 0.0)
            return h / torch.clamp_min(torch.linalg.vector_norm(h, dim=-1, keepdim=True), _NORM_EPS)

    def states(self, dense: Any, hist_emb: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) history and (B, L) mask -> (B, L, D): every position's
        state after the last block (zeros at padding)."""
        cd = self.compute_dtype
        d = self.cfg.n_factors
        nh = self.cfg.hstu_heads
        bsz, l, _ = hist_emb.shape
        mask_f = hist_mask.to(cd)[..., None]
        x = (hist_emb.to(cd) * math.sqrt(d) + dense["pos"][:l].to(cd)[None]) * mask_f
        valid = hist_mask.contiguous()
        for blk in dense["blocks"]:
            z = layer_norm_unit(x, _LN_EPS)
            u, v, q, k = torch.split(F.silu(z @ blk["uvqk"]["w"].to(cd)), d, dim=-1)
            o = pointwise_attention(q, k, v, blk["rab_pos"].to(cd), valid, nh)
            y = (layer_norm_unit(o, _LN_EPS) * u) @ blk["o"]["w"].to(cd) + blk["o"]["b"].to(cd)
            x = (x + y) * mask_f  # padded positions stay inert through the stack
        return x

"""SASRec self-attentive history encoder (port of
``torchrecsys_tpu/models/sasrec.py``; Kang & McAuley 2018).

``sasrec_blocks`` pre-norm blocks of causal multi-head self-attention and
a relu feed-forward over the (B, L, D) history plus learned positions,
then a final layer norm; the user vector is the hidden state at the last
valid position (an empty history encodes to zeros). The positions ``pos``
are a dense parameter, sliced ``[:L]``: their gradient goes to the dense
optimizer, not to an embedding update. The attention is written out as the
JAX package does: an additive ``-1e9`` causal + key-padding mask in the
compute dtype, a softmax in f32 cast back. The layer norms go through
ops/layer_norm.py: its kernels on CUDA tensors, the plain formula on the
CPU. Tables, gathers, scoring and serving: models/sequence.py.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from torchrecsys_tpu_torch.models.base import uniform_linear_init
from torchrecsys_tpu_torch.models.sequence import SequenceModel
from torchrecsys_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain

_LN_EPS = 1e-6


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain layer norm at the encoder's eps (the CPU path of
    :func:`layer_norm`)."""
    return layer_norm_plain(x, scale, bias, _LN_EPS)


class SASRecModel(SequenceModel):
    name = "sasrec"

    def __init__(self, schema, cfg) -> None:
        super().__init__(schema, cfg)
        if cfg.n_factors % cfg.sasrec_heads:
            raise ValueError(
                f"sasrec: n_factors={cfg.n_factors} must be divisible by "
                f"sasrec_heads={cfg.sasrec_heads}"
            )

    def _ln_params(self, d: int, device) -> Dict[str, torch.Tensor]:
        return {
            "scale": torch.ones((d,), dtype=self.param_dtype, device=device),
            "bias": torch.zeros((d,), dtype=self.param_dtype, device=device),
        }

    def init_dense(self, generator: torch.Generator) -> Any:
        """``{"blocks": [{qkv (d, 3d), attn_out, ffn1, ffn2 (d, d), ln1,
        ln2}], "ln_out", "pos" (history_len, d) ~ N(0, 1/d)}``
        (sasrec.py:76-107)."""
        d = self.cfg.n_factors
        dev, dt = generator.device, self.param_dtype
        blocks = [
            {
                "qkv": uniform_linear_init(generator, d, 3 * d, dt),
                "attn_out": uniform_linear_init(generator, d, d, dt),
                "ffn1": uniform_linear_init(generator, d, d, dt),
                "ffn2": uniform_linear_init(generator, d, d, dt),
                "ln1": self._ln_params(d, dev),
                "ln2": self._ln_params(d, dev),
            }
            for _ in range(self.cfg.sasrec_blocks)
        ]
        pos = (torch.randn((self.cfg.history_len, d), generator=generator, device=dev) * (1.0 / d)).to(dt)
        return {"blocks": blocks, "ln_out": self._ln_params(d, dev), "pos": pos}

    def _encode(self, dense: Any, hist_emb: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) history and (B, L) mask -> (B, D): the hidden state at
        each row's last valid position (sasrec.py:127-187)."""
        cd = self.compute_dtype
        d = self.cfg.n_factors
        nh = self.cfg.sasrec_heads
        dh = d // nh
        bsz, l, _ = hist_emb.shape
        mask_f = hist_mask.to(cd)[..., None]
        x = (hist_emb.to(cd) + dense["pos"][:l].to(cd)[None]) * mask_f
        causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
        allowed = causal[None] & hist_mask[:, None, :]
        bias = torch.where(allowed, 0.0, -1e9).to(cd)[:, None]  # (B, 1, L, L)

        def lin(blk, name, z):
            return z @ blk[name]["w"].to(cd) + blk[name]["b"].to(cd)

        for blk in dense["blocks"]:
            z = layer_norm(x, blk["ln1"]["scale"].to(cd), blk["ln1"]["bias"].to(cd), _LN_EPS)
            qkv = lin(blk, "qkv", z).reshape(bsz, l, 3, nh, dh)
            q, k, v = (qkv[:, :, i].movedim(1, 2) for i in range(3))  # (B, h, L, dh)
            scores = (q @ k.transpose(-1, -2)) * (dh**-0.5) + bias
            attn = torch.softmax(scores.float(), dim=-1).to(cd)
            ctx = (attn @ v).movedim(1, 2).reshape(bsz, l, d)
            x = x + lin(blk, "attn_out", ctx)
            z = layer_norm(x, blk["ln2"]["scale"].to(cd), blk["ln2"]["bias"].to(cd), _LN_EPS)
            x = x + lin(blk, "ffn2", torch.relu(lin(blk, "ffn1", z)))
            x = x * mask_f  # padded positions stay inert through the stack
        x = layer_norm(x, dense["ln_out"]["scale"].to(cd), dense["ln_out"]["bias"].to(cd), _LN_EPS)
        pos_idx = torch.arange(l, device=x.device)
        last = torch.max(torch.where(hist_mask, pos_idx[None, :], -1), dim=1).values
        h_last = torch.gather(x, 1, last.clamp_min(0)[:, None, None].expand(bsz, 1, d))[:, 0]
        return torch.where((last >= 0)[:, None], h_last, 0.0)

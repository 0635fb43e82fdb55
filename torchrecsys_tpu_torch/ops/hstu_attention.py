"""HSTU's pointwise attention: one hand-written Hopper kernel forward, one
backward (kernel pair #9), and the plain version.

It replaces no TPU kernel: HSTU exists only in the port
(``models/hstu.py``). Per history b and head h, with q, k, v slices of the
(B, L, h * dh) projections, w the block's relative-position weights and the
(B, L) mask of valid positions:

    o_i = sum_j SiLU(q_i . k_j + w[j - i + L - 1]) * f32(1 / L) * M[b, i, j] * v_j
    M[b, i, j] = [j <= i] and valid[b, j]

(``csrc/hstu_attention.cu`` says what bounds the kernels and what their
design does about it: nothing (B, h, L, L) reaches device memory, and the
backward recomputes the scores on chip.)

- :func:`pointwise_attention_plain` is that function in plain torch,
  differentiable by autograd: the CPU path and the yardstick on the card.
  R comes from ``models/hstu.py::relative_bias``, looked up at call time.
- :func:`hstu_attention_fwd` launches the forward: o (B, L, h * dh).
- :func:`hstu_attention_bwd` launches the backward and the fixed-order sum
  of its dw partials: ``(dq, dk, dv, dw)`` for a cotangent dO.
  Both wrappers take CUDA tensors q, k, v (B, L, h * dh; any batch and row
  strides, the last dim contiguous), w (at least 2L - 1 weights; dw has w's
  shape, 0 past L - 1) in one type, f32 or bf16 (the arithmetic is f32 in
  both), and a contiguous (B, L) bool mask, at any L and dh (a problem
  that fits shared memory whole is staged there, any other is streamed).
  Each counts its launches in ``.launches`` and in the
  ``hstu_attention.fwd_launches`` / ``hstu_attention.bwd_launches``
  counters (``utils/profiling.py``).
- :class:`PointwiseAttention` is the ``torch.autograd.Function`` over the
  two; it saves q, k, v, w and the mask, nothing (B, h, L, L).
- :func:`pointwise_attention` is the entry: CPU tensors take the plain
  version, CUDA tensors the kernels, with no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.ops.dot_topk import _check as _raise_on
from torchrecsys_tpu_torch.ops.dot_topk import _stream
from torchrecsys_tpu_torch.utils.profiling import count

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def pointwise_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                              valid: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, h * dh) q, k, v, the block's weights w and the (B, L) mask
    -> (B, L, h * dv): per head ``(SiLU(q k^T + R) / L) * M`` times v, with R
    from ``relative_bias(w, L)`` and M causal and valid. In place where
    autograd allows (each op's saved tensors are not the ones overwritten)."""
    from torchrecsys_tpu_torch.models import hstu  # looked up at call time; hstu imports this module

    bsz, length, width = q.shape
    rab = hstu.relative_bias(w, length)
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=q.device))
    blocked = ~(causal[None] & valid[:, None, :])[:, None]  # (B, 1, L, L)

    def split(t):  # (B, L, h * dh) -> (B, h, L, dh)
        return t.reshape(bsz, length, heads, width // heads).transpose(1, 2)

    scores = split(q) @ split(k).transpose(-1, -2)
    scores += rab
    attn = F.silu(scores)
    attn *= 1.0 / length
    attn.masked_fill_(blocked, 0.0)
    o = attn @ split(v)
    return o.transpose(1, 2).reshape(bsz, length, o.shape[1] * o.shape[3])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("hstu_attention.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_hstu_attention_parts.argtypes = [_CI] * 5
        lib.trs_hstu_attention_parts.restype = _CI
        lib.trs_hstu_attention_fwd.argtypes = [_VP] * 7 + [_CI] * 4 + [ctypes.c_float, _CI, _VP]
        lib.trs_hstu_attention_fwd.restype = _CI
        lib.trs_hstu_attention_bwd.argtypes = [_VP] * 11 + [_CI] * 2 + [_VP] + [_CI] * 4 + [ctypes.c_float, _CI, _VP]
        lib.trs_hstu_attention_bwd.restype = _CI
        lib._trs_bound = True
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
           heads: int, dout: torch.Tensor = None) -> Tuple[int, int, int, int]:
    """q, k, v (and dout) (B, L, heads * dh) with L, dh >= 1, w 1-d with at
    least 2L - 1 weights, all of q's type, f32 or bf16, the last
    dim contiguous; valid (B, L) bool, contiguous; one device. Returns (B, L,
    heads, dh); :func:`_on_card` then asks for CUDA."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (B, L, heads * dh), got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    bsz, length, width = q.shape
    if heads < 1 or width % heads or length < 1 or width < heads:
        raise ValueError(f"{name}: expected (B, L, heads * dh) with L, dh >= 1, got {tuple(q.shape)} with "
                         f"heads={heads}")
    rows = (k, v) + ((dout,) if dout is not None else ())
    for t in rows + (w,):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: every input must be q's {q.dtype}, got {t.dtype}")
    for t in rows:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name}: expected {tuple(q.shape)} beside q, got {tuple(t.shape)}")
    if w.dim() != 1 or w.shape[0] < 2 * length - 1:
        raise ValueError(f"{name}: w must be 1-d with at least 2L - 1 = {2 * length - 1} weights, "
                         f"got {tuple(w.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (bsz, length):
        raise ValueError(f"{name}: the mask must be ({bsz}, {length}) bool, got {tuple(valid.shape)} {valid.dtype}")
    for t in rows + (w, valid):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {q.device})")
    if any(t.stride(-1) != 1 for t in (q,) + rows + (w,)) or not valid.is_contiguous():
        raise ValueError(f"{name}: q, k, v, dout and w need a last-dim stride of 1 and the mask must be "
                         "contiguous")
    return bsz, length, heads, width // heads


def _on_card(name: str, q: torch.Tensor) -> torch.device:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {q.device} (pointwise_attention_plain is "
                         "the CPU's version)")
    return q.device


def _strides(*ts: torch.Tensor) -> torch.Tensor:
    """The batch and row strides of each tensor, as the C entries read them."""
    return torch.tensor([s for t in ts for s in (t.stride(0), t.stride(1))], dtype=torch.int64)


def hstu_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """o (B, L, heads * dh), contiguous, in q's type. Launches the forward on
    the current stream."""
    bsz, length, nh, dh = _check("hstu_attention_fwd", q, k, v, w, valid, heads)
    dev = _on_card("hstu_attention_fwd", q)
    o = torch.empty((bsz, length, nh * dh), dtype=q.dtype, device=dev)
    strides = _strides(q, k, v, q)
    with torch.cuda.device(dev):
        rc = _lib().trs_hstu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), valid.data_ptr(), o.data_ptr(),
            strides.data_ptr(), bsz, nh, length, dh, 1.0 / length, int(q.dtype == torch.bfloat16), _stream(dev),
        )
    _raise_on(rc, "hstu_attention_fwd")
    hstu_attention_fwd.launches += 1
    count("hstu_attention.fwd_launches")
    return o


hstu_attention_fwd.launches = 0


def hstu_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
                       dout: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv, dw)``: dq, dk, dv (B, L, heads * dh) contiguous and dw of
    w's shape, all in q's type. Launches the backward (dq, dk, dv, and a row
    of dw partials a block) and the fixed-order sum of the partials."""
    bsz, length, nh, dh = _check("hstu_attention_bwd", q, k, v, w, valid, heads, dout)
    dev = _on_card("hstu_attention_bwd", q)
    bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = (torch.empty((bsz, length, nh * dh), dtype=q.dtype, device=dev) for _ in range(3))
    dw = torch.empty_like(w)
    strides = _strides(q, k, v, dout)
    with torch.cuda.device(dev):
        lib = _lib()
        parts = lib.trs_hstu_attention_parts(bsz, nh, length, dh, bf16)
        if parts < 1:
            raise RuntimeError(f"hstu_attention_bwd: no launch plan for {tuple(q.shape)} with heads={nh}")
        part = torch.empty((parts, length), dtype=torch.float32, device=dev)
        rc = lib.trs_hstu_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), valid.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(), dw.data_ptr(), parts, w.shape[0],
            strides.data_ptr(), bsz, nh, length, dh, 1.0 / length, bf16, _stream(dev),
        )
    _raise_on(rc, "hstu_attention_bwd")
    hstu_attention_bwd.launches += 1
    count("hstu_attention.bwd_launches")
    return dq, dk, dv, dw


hstu_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class PointwiseAttention(torch.autograd.Function):
    """The pointwise attention through :func:`hstu_attention_fwd` and
    :func:`hstu_attention_bwd`; saves q, k, v, w and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, w, valid, heads: int):
        o = hstu_attention_fwd(q, k, v, w, valid, heads)
        ctx.save_for_backward(q, k, v, w, valid)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, w, valid = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv, dw = hstu_attention_bwd(q, k, v, w, valid, dout, ctx.heads)
        return dq, dk, dv, dw, None, None


def pointwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, valid: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """HSTU's pointwise attention: :func:`pointwise_attention_plain` for CPU
    tensors, the kernels (:class:`PointwiseAttention`) for CUDA tensors."""
    if q.device.type == "cpu":
        return pointwise_attention_plain(q, k, v, w, valid, heads)
    return PointwiseAttention.apply(q, k, v, w, valid, heads)

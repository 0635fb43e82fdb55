"""The sequence encoder's layer norm: one hand-written Hopper kernel
forward, one backward, and the plain version.

It replaces no TPU kernel: the JAX package writes SASRec's norm as jnp ops
(``torchrecsys_tpu/models/sasrec.py``) and XLA fuses them, while eager
PyTorch runs the formula as a chain of separate ops, each a pass over the
activations (``csrc/layer_norm.cu`` says why the kernels are bound by
bytes and what their design does about it). Over the last dim of x, with
``eps`` added to the biased variance:

    y = (x - mean) * rsqrt(var + eps) * scale + bias

- :func:`layer_norm_plain` is that formula in plain torch, differentiable
  by autograd: the CPU path and the yardstick on the card.
- :func:`layer_norm_fwd` launches the forward: ``(y, mean, rstd)`` for
  (rows, d) x, the per-row mean and rstd in f32.
- :func:`layer_norm_bwd` launches the backward and the fixed-order column
  sums of its partials: ``(dx, dscale, dbias)`` for a cotangent dy, with
  ``xhat = (x - mean) * rstd``, ``g = dy * scale``, ``dx = rstd * (g -
  mean_row(g) - xhat * mean_row(g * xhat))``, ``dscale = sum_rows dy *
  xhat`` and ``dbias = sum_rows dy``.
  Both wrappers take CUDA tensors x, dy, scale and bias in one type, f32
  or bf16 (the arithmetic is f32 in both), contiguous; each counts its
  launches in ``.launches``.
- :class:`LayerNorm` is the ``torch.autograd.Function`` over the two;
  :func:`layer_norm` the entry: CPU tensors take :func:`layer_norm_plain`,
  CUDA tensors the kernels, with no fallback.
- :func:`layer_norm_unit` is the entry for a norm without affine
  parameters (HSTU's two a block): :func:`layer_norm` with a constant
  scale of ones and bias of zeros, kept per width, type and device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.ops.dot_topk import _check as _raise_on
from torchrecsys_tpu_torch.ops.dot_topk import _stream

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)
_UNIT: Dict[Tuple[int, torch.dtype, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The layer norm over the last dim as torch ops, in x's type: the mean,
    the biased variance as the mean of the squared deviations, ``rsqrt``."""
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean(torch.square(x - m), dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("layer_norm.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_layer_norm_parts.argtypes = [_CLL, _CI, _CI]
        lib.trs_layer_norm_parts.restype = _CI
        lib.trs_layer_norm_fwd.argtypes = [_VP] * 6 + [_CLL, _CI, ctypes.c_float, _CI, _VP]
        lib.trs_layer_norm_fwd.restype = _CI
        lib.trs_layer_norm_bwd.argtypes = [_VP] * 10 + [_CLL, _CI, _CI, _VP]
        lib.trs_layer_norm_bwd.restype = _CI
        lib._trs_bound = True
    return lib


def _check(
    name: str, x: torch.Tensor, rowwise: Tuple[torch.Tensor, ...], params: Tuple[torch.Tensor, ...]
) -> Tuple[int, int]:
    """x (rows, d), tensors of its shape (``rowwise``: dy) and (d,) ones
    (``params``: scale, bias), all of x's type, f32 or bf16, on x's device
    and contiguous. Returns (rows, d); :func:`_on_card` then asks for
    CUDA."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{name}: x must be (rows, d) with d >= 1, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    rows, d = x.shape
    for want, ts in (((rows, d), rowwise), ((d,), params)):
        for t in ts:
            if t.dtype != x.dtype:
                raise TypeError(f"{name}: every input must be x's {x.dtype}, got {t.dtype}")
            if tuple(t.shape) != want:
                raise ValueError(f"{name}: expected {want} beside x {tuple(x.shape)}, got {tuple(t.shape)}")
            if t.device != x.device:
                raise ValueError(f"{name}: inputs on different devices ({t.device} vs {x.device})")
    if not all(t.is_contiguous() for t in (x,) + rowwise + params):
        raise ValueError(f"{name}: inputs must be contiguous")
    return rows, d


def _check_stats(name: str, x: torch.Tensor, *stats: torch.Tensor) -> None:
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0],) or not t.is_contiguous():
            raise ValueError(f"{name}: mean and rstd must be contiguous ({x.shape[0]},) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {x.device})")


def _on_card(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {x.device} (layer_norm_plain is the "
                         "CPU's version)")
    return x.device


def layer_norm_fwd(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: y in x's type, mean and rstd (rows,) f32. Launches
    the forward on the current stream (a row per warp, in registers)."""
    rows, d = _check("layer_norm_fwd", x, (), (scale, bias))
    dev = _on_card("layer_norm_fwd", x)
    y = torch.empty_like(x)
    mean = torch.empty((rows,), dtype=torch.float32, device=dev)
    rstd = torch.empty((rows,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().trs_layer_norm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            rows, d, float(eps), int(x.dtype == torch.bfloat16), _stream(dev),
        )
    _raise_on(rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_bwd(
    x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)``, all in x's type. Launches the backward (dx,
    and a row of per-column partials a block) and the fixed-order sum of
    the partials."""
    rows, d = _check("layer_norm_bwd", x, (dy,), (scale,))
    _check_stats("layer_norm_bwd", x, mean, rstd)
    dev = _on_card("layer_norm_bwd", x)
    bf16 = int(x.dtype == torch.bfloat16)
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=x.dtype, device=dev)
    dbias = torch.empty((d,), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        lib = _lib()
        parts = lib.trs_layer_norm_parts(rows, d, bf16)
        part = torch.empty((2, parts, d), dtype=torch.float32, device=dev)
        rc = lib.trs_layer_norm_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), dscale.data_ptr(), dbias.data_ptr(), rows, d, bf16,
            _stream(dev),
        )
    _raise_on(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class LayerNorm(torch.autograd.Function):
    """The layer norm over x's last dim through :func:`layer_norm_fwd` and
    :func:`layer_norm_bwd`; saves x, scale and the per-row mean and rstd."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        x2 = x.reshape(-1, x.shape[-1])
        y, mean, rstd = layer_norm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, mean, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x2, dy.contiguous().view(x2.shape), scale, mean, rstd)
        return dx.view(dy.shape), dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm over the last dim: :func:`layer_norm_plain` for CPU
    tensors, the kernels (:class:`LayerNorm`) for CUDA tensors, which must
    be f32 or bf16 and contiguous."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    return LayerNorm.apply(x, scale, bias, eps)


def layer_norm_unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`layer_norm` without affine parameters: scale 1 and bias 0,
    constants made once per (d, type, device) and kept."""
    key = (x.shape[-1], x.dtype, x.device)
    params = _UNIT.get(key)
    if params is None:
        params = _UNIT[key] = (torch.ones(key[0], dtype=x.dtype, device=x.device),
                               torch.zeros(key[0], dtype=x.dtype, device=x.device))
    return layer_norm(x, *params, eps)

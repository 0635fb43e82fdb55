"""One MLP tower layer, ``[BN -> ReLU ->] matmul + bias`` with the output's
batch statistics: two hand-written Hopper kernels and their plain versions.

Port of ``torchrecsys_tpu/ops/fused_tower.py`` (single device). For input
rows ``x`` (R, Din) bf16, weights ``w`` (Din, Dout) bf16, bias ``b`` (Dout,)
bf16 and the input's batch-norm rows ``bn = (mean, inv, scale, bias)`` (4,
Din) bf16 (used only with ``has_bn``, layers after the first):

    h = relu(((x - mean) * inv) * scale + bias)   (bf16 ops)   or   h = x
    z = bf16(h @ w, f32 sums) + b                  (bf16 add)
    s = sum_r f32(z),  ss = sum_r f32(bf16(z * z))

- :func:`fused_tower_fwd` launches the forward (``csrc/fused_tower.cu``),
  the port of ``_fwd_kernel`` (:75-98) as ``_fwd_call`` (:101-131) calls
  it: ``(z, s, ss)``.
- :func:`fused_tower_bwd` launches the backward, the port of
  ``_bwd_kernel`` (:139-194) as ``_bwd_call`` (:197-237) calls it: for the
  cotangents ``dz`` (R, Dout) bf16 and ``dstat = (ds, dss)`` (2, Dout) f32,
  ``(din (R, Din) bf16, dw (Din, Dout) f32, db (Dout,) f32, dbn (4, Din)
  f32)`` with dbn's rows (dscale, dbias, dmean, dinv); zeros without BN.

  Given CPU tensors each takes its plain version
  (:func:`fused_tower_fwd_plain`, :func:`fused_tower_bwd_plain`: plain
  torch with the same bf16 rounding points and the f32 products written
  out); given CUDA tensors it launches its kernels or raises. Each counts
  its launches in ``.launches``.
- :class:`FusedLayer` is the ``jax.custom_vjp`` (:245-284) as a
  ``torch.autograd.Function``; :func:`fused_layer` its entry.

Unlike the TPU kernels (``rows % TILE == 0``), the kernels take any row
count, so :func:`tower_applicable` has no row condition.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.ops.dot_topk import _check as _raise_on
from torchrecsys_tpu_torch.ops.dot_topk import _ieee_f32_matmul, _stream

_VP, _CI = ctypes.c_void_p, ctypes.c_int
BF16 = torch.bfloat16


def tower_applicable(cfg) -> bool:
    """The gate of ``tower_applicable`` (:287-309) for a training forward in
    bf16 compute: batch norm on and at least one hidden layer (an empty
    tower has nothing to fuse). The device chooses the kernel, so there is
    no ``pallas_tower`` switch, and any row count is taken."""
    return bool(cfg.use_batch_norm) and len(cfg.hidden_layers) > 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def bn_relu(x: torch.Tensor, bn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(relu(y), xhat)`` with ``xhat = (x - mean) * inv`` and ``y = xhat *
    scale + bias``, each op in bf16 (``_bn_relu``, :64-67)."""
    xhat = (x - bn[0]) * bn[1]
    return torch.relu(xhat * bn[2] + bn[3]), xhat


def fused_tower_fwd_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bn: torch.Tensor, has_bn: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's contract: ``(z (R, Dout) bf16, s, ss (Dout,)
    f32)``."""
    h = bn_relu(x, bn)[0] if has_bn else x
    with _ieee_f32_matmul(x.device):
        z = (h.float() @ w.float()).to(BF16) + b
    return z, z.float().sum(0), (z * z).float().sum(0)


def fused_tower_bwd_plain(
    x: torch.Tensor,
    z: torch.Tensor,
    dz: torch.Tensor,
    w: torch.Tensor,
    bn: torch.Tensor,
    dstat: torch.Tensor,
    has_bn: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract: ``(din, dw, db, dbn)`` as above."""
    ds, dss = dstat[0], dstat[1]
    dzp = (dz.float() + ds + 2.0 * z.float() * dss).to(BF16)
    h, xhat = bn_relu(x, bn) if has_bn else (x, None)
    with _ieee_f32_matmul(x.device):
        dw = h.float().T @ dzp.float()
        dh = (dzp.float() @ w.float().T).to(BF16)
    db = dzp.float().sum(0)
    dbn = torch.zeros((4, x.shape[1]), dtype=torch.float32, device=x.device)
    if not has_bn:
        return dh, dw, db, dbn
    scale, inv = bn[2].float(), bn[1].float()
    mask = (xhat * bn[2] + bn[3]).float() > 0.0
    dy = torch.where(mask, dh, torch.zeros_like(dh)).float()
    dbn[0] = (dy * xhat.float()).sum(0)
    dbn[1] = dy.sum(0)
    dbn[2] = (-dy * scale * inv).sum(0)
    dbn[3] = (dy * scale * (x.float() - bn[0].float())).sum(0)
    return (dy * scale * inv).to(BF16), dw, db, dbn


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_tower.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_fused_tower_fwd_scratch.argtypes = [_CI] * 3
        lib.trs_fused_tower_fwd_scratch.restype = ctypes.c_longlong
        lib.trs_fused_tower_bwd_scratch.argtypes = [_CI] * 4
        lib.trs_fused_tower_bwd_scratch.restype = ctypes.c_longlong
        lib.trs_fused_tower_fwd.argtypes = [_VP] * 4 + [_CI] * 4 + [_VP] * 4
        lib.trs_fused_tower_fwd.restype = _CI
        lib.trs_fused_tower_bwd.argtypes = [_VP] * 6 + [_CI] * 4 + [_VP] * 6
        lib.trs_fused_tower_bwd.restype = _CI
        lib._trs_bound = True
    return lib


def _check(name: str, x, w, bn, *rows_dout: torch.Tensor) -> Tuple[int, int, int]:
    """Shapes, dtypes and devices of a layer's inputs; returns (R, Din,
    Dout). ``rows_dout`` are further (R, Dout) bf16 inputs."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x (R, Din) and w (Din, Dout) expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    r, din = x.shape
    dout = w.shape[1]
    if r < 1 or din < 1 or dout < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)} x {tuple(w.shape)}")
    if tuple(bn.shape) != (4, din):
        raise ValueError(f"{name}: bn must be (4, {din}), got {tuple(bn.shape)}")
    for t in rows_dout:
        if tuple(t.shape) != (r, dout):
            raise ValueError(f"{name}: expected ({r}, {dout}), got {tuple(t.shape)}")
    for t in (x, w, bn) + rows_dout:
        if t.dtype != BF16:
            raise ValueError(f"{name}: bf16 inputs expected, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {x.device})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {x.device}")
    return r, din, dout


def fused_tower_fwd(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bn: torch.Tensor, has_bn: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(z, s, ss)``; the contract of :func:`fused_tower_fwd_plain`. CUDA
    tensors launch the forward (``wgmma`` over a row tile that walks its
    output column tiles, h formed in place, z stored through shared
    memory) and the fixed-order sum of its per-tile statistics on the
    current stream; CPU tensors take the plain version."""
    r, din, dout = _check("fused_tower_fwd", x, w, bn)
    if tuple(b.shape) != (dout,) or b.dtype != BF16 or b.device != x.device:
        raise ValueError(f"fused_tower_fwd: b must be ({dout},) bf16 on {x.device}")
    if x.device.type == "cpu":
        return fused_tower_fwd_plain(x, w, b, bn, has_bn)
    dev = x.device
    x, w, b, bn = (t.contiguous() for t in (x, w, b, bn))
    lib = _lib()
    n = int(lib.trs_fused_tower_fwd_scratch(r, din, dout))
    buf = torch.empty((n + 2 * dout,), dtype=torch.float32, device=dev)  # scratch, s, ss
    z = torch.empty((r, dout), dtype=BF16, device=dev)
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.trs_fused_tower_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), bn.data_ptr(), r, din, dout, int(has_bn),
            p, z.data_ptr(), p + 4 * n, _stream(dev),
        )
    _raise_on(rc, "fused_tower_fwd")
    fused_tower_fwd.launches += 1
    return z, buf[n : n + dout], buf[n + dout :]


fused_tower_fwd.launches = 0


def fused_tower_bwd(
    x: torch.Tensor,
    z: torch.Tensor,
    dz: torch.Tensor,
    w: torch.Tensor,
    bn: torch.Tensor,
    dstat: torch.Tensor,
    has_bn: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(din, dw, db, dbn)``; the contract of :func:`fused_tower_bwd_plain`.
    CUDA tensors launch the dh product (wgmma, with the BN epilogue), the
    dW/db product over row ranges (wgmma) and the fixed-order sums of
    their partials; CPU tensors take the plain version."""
    r, din, dout = _check("fused_tower_bwd", x, w, bn, z, dz)
    if tuple(dstat.shape) != (2, dout) or dstat.device != x.device:
        raise ValueError(f"fused_tower_bwd: dstat must be (2, {dout}) on {x.device}")
    if x.device.type == "cpu":
        return fused_tower_bwd_plain(x, z, dz, w, bn, dstat, has_bn)
    dev = x.device
    x, z, dz, w, bn = (t.contiguous() for t in (x, z, dz, w, bn))
    dstat = dstat.to(torch.float32).contiguous()
    lib = _lib()
    part = torch.empty((lib.trs_fused_tower_bwd_scratch(r, din, dout, int(has_bn)),),
                       dtype=torch.float32, device=dev)
    din_g = torch.empty((r, din), dtype=BF16, device=dev)
    out = torch.empty((din * dout + dout + 4 * din,), dtype=torch.float32, device=dev)
    dw = out[: din * dout].view(din, dout)
    db = out[din * dout : din * dout + dout]
    dbn = out[din * dout + dout :].view(4, din)
    with torch.cuda.device(dev):
        rc = lib.trs_fused_tower_bwd(
            x.data_ptr(), z.data_ptr(), dz.data_ptr(), w.data_ptr(), bn.data_ptr(),
            dstat.data_ptr(), r, din, dout, int(has_bn), part.data_ptr(), din_g.data_ptr(),
            dw.data_ptr(), db.data_ptr(), dbn.data_ptr(),
            _stream(dev),
        )
    _raise_on(rc, "fused_tower_bwd")
    fused_tower_bwd.launches += 1
    return din_g, dw, db, dbn


fused_tower_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FusedLayer(torch.autograd.Function):
    """``(z, s, ss)`` of one layer, differentiable in ``x``, the bf16
    ``w``, ``b`` and the ``(mean, inv, scale, bias)`` rows ``bnvec``
    (``fused_layer``, :245-284). It saves ``x`` and ``z``, as the JAX
    residuals do, and the backward recomputes h from x."""

    @staticmethod
    def forward(ctx, x, w, b, bnvec, has_bn: bool):
        z, s, ss = fused_tower_fwd(x, w, b, bnvec, has_bn)
        ctx.save_for_backward(x, z, w, bnvec)
        ctx.has_bn = has_bn
        return z, s, ss

    @staticmethod
    def backward(ctx, dz, ds, dss):
        x, z, w, bnvec = ctx.saved_tensors
        dstat = torch.stack([ds, dss]).float()
        din, dw, db, dbn = fused_tower_bwd(x, z, dz.contiguous(), w, bnvec, dstat, ctx.has_bn)
        # the kernel's rows (dscale, dbias, dmean, dinv) in bnvec's
        # (mean, inv, scale, bias) order (:273-275)
        dbn_bf = torch.stack([dbn[2], dbn[3], dbn[0], dbn[1]]).to(BF16)
        return din, dw.to(BF16), db.to(BF16), dbn_bf, None


def fused_layer(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    bnvec: torch.Tensor,
    has_bn: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tower layer with its output statistics (:245-259): ``(z (R,
    Dout) bf16, s (Dout,) f32, ss (Dout,) f32)``."""
    return FusedLayer.apply(x, w, b, bnvec, has_bn)

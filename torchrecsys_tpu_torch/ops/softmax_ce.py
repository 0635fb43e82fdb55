"""In-batch sampled-softmax cross-entropy: two hand-written Hopper kernels
and their plain versions.

Port of ``torchrecsys_tpu/ops/softmax_ce.py`` (single device) and of the
XLA formulation it replaces, ``_inbatch_softmax_rows``
(``train/trainer.py:107-139``). For B rows with user-side vectors ``h``
(B, D), item-side vectors ``v`` (B, D), column biases ``vbq = item bias -
logq[pos]`` (B,) and positive item ids ``pos`` (B,), every row scores
every row's positive:

    s[r, c] = h[r] . v[c] + vbq[c]   (-inf where pos[c] == pos[r], c != r)
    lse[r] = logsumexp_c s[r, c],    loss[r] = lse[r] - s[r, r]

- :func:`softmax_ce_fwd` launches the forward (``csrc/softmax_ce.cu``),
  the port of ``_fwd_kernel`` (:67-89) as ``_call_fwd`` (:148-173) calls
  it: ``(loss, lse)``.
- :func:`softmax_ce_bwd` launches the backward, the port of
  ``_bwd_kernel`` (:92-125) as ``_ce_bwd`` (:187-225) calls it: ``(dh, dv,
  dvb)`` for a per-row cotangent ``g``.

  Given CPU tensors each takes its plain version
  (:func:`softmax_ce_fwd_plain`, :func:`softmax_ce_bwd_plain`); given CUDA
  tensors it launches its kernels or raises. Each counts its launches in
  ``.launches``.
- :class:`InBatchSoftmaxCE` is the ``jax.custom_vjp`` (:176-228) as a
  ``torch.autograd.Function``; :func:`inbatch_softmax_ce` its entry.
- :func:`inbatch_softmax_rows_plain` is the XLA formulation, taken for
  ``d > 128`` (:func:`softmax_kernel_applicable`), as the JAX package does.

The matmuls are f32 (IEEE on the card: the plain versions switch TF32 off
around their products; both kernels' products are 3xTF32 on the tensor
cores, f32-accurate to ~2^-21). The data-parallel wrapper
``inbatch_softmax_ce_dp`` (:240-264) waits for ROADMAP.md §A item 14.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.ops.dot_topk import _check as _raise_on
from torchrecsys_tpu_torch.ops.dot_topk import _ieee_f32_matmul, _stream

LANES = 128  # widest D the kernels take (the TPU kernel's lane width)
_VP, _CI = ctypes.c_void_p, ctypes.c_int


def softmax_kernel_applicable(b: int, d: int) -> bool:
    """True when the CE runs through the kernels: ``d <= 128``. The kernels
    mask their ragged row and column edges, so unlike the TPU kernel
    (:53-64) any batch size ``b >= 1`` is taken."""
    return b >= 1 and 1 <= d <= LANES


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _dup_mask(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, B) accidental-hit mask (same positive, off the diagonal) and the
    identity."""
    eye = torch.eye(pos.shape[0], dtype=torch.bool, device=pos.device)
    return (pos[None, :] == pos[:, None]) & ~eye, eye


def inbatch_softmax_rows_plain(
    h: torch.Tensor,
    v: torch.Tensor,
    vb: torch.Tensor,
    pos: torch.Tensor,
    logq: Optional[torch.Tensor],
) -> torch.Tensor:
    """(B,) per-row in-batch CE, the XLA formulation (trainer.py:107-139):
    one ``h @ v.T``, the logQ correction of every column, duplicates masked
    to -inf off the diagonal, logsumexp minus the diagonal label.
    Differentiable by torch autograd."""
    with _ieee_f32_matmul(h.device):
        logits = (h @ v.T).float() + vb.float()[None, :]
    if logq is not None:
        logits = logits - logq[pos][None, :]
    dup, _ = _dup_mask(pos)
    logits = logits.masked_fill(dup, -torch.inf)
    return torch.logsumexp(logits, dim=1) - torch.diagonal(logits)


def _masked_logits(h, v, vbq, pos) -> Tuple[torch.Tensor, torch.Tensor]:
    with _ieee_f32_matmul(h.device):
        s = h.float() @ v.float().T
    dup, eye = _dup_mask(pos)
    return (s + vbq.float()[None, :]).masked_fill(dup, -torch.inf), eye


def softmax_ce_fwd_plain(
    h: torch.Tensor, v: torch.Tensor, vbq: torch.Tensor, pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's contract: ``(loss (B,), lse (B,))`` f32."""
    s, _ = _masked_logits(h, v, vbq, pos)
    lse = torch.logsumexp(s, dim=1)
    return lse - torch.diagonal(s), lse


def softmax_ce_bwd_plain(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract: with ``dlog = g * (softmax -
    onehot)`` (masked logits have probability 0), ``(dh = dlog @ v,
    dv = dlog.T @ h, dvb = dlog.sum(0))``, f32."""
    s, eye = _masked_logits(h, v, vbq, pos)
    dlog = g.float()[:, None] * (torch.exp(s - lse[:, None]) - eye.float())
    with _ieee_f32_matmul(h.device):
        dh = dlog @ v.float()
        dv = dlog.T @ h.float()
    return dh, dv, dlog.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("softmax_ce.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_softmax_ce_fwd_scratch.argtypes = [_CI] * 2
        lib.trs_softmax_ce_fwd_scratch.restype = ctypes.c_longlong
        lib.trs_softmax_ce_bwd_scratch.argtypes = [_CI] * 2
        lib.trs_softmax_ce_bwd_scratch.restype = ctypes.c_longlong
        lib.trs_softmax_ce_fwd.argtypes = [_VP] * 4 + [_CI] * 2 + [_VP] * 4
        lib.trs_softmax_ce_fwd.restype = _CI
        lib.trs_softmax_ce_bwd.argtypes = [_VP] * 6 + [_CI] * 2 + [_VP] * 5
        lib.trs_softmax_ce_bwd.restype = _CI
        lib._trs_bound = True
    return lib


def _check(name: str, h, v, vbq, pos, *rows: torch.Tensor) -> Tuple[int, int]:
    """Shapes and devices of the CE inputs; returns (B, D)."""
    if h.dim() != 2 or tuple(v.shape) != tuple(h.shape):
        raise ValueError(f"{name}: h and v must be (B, D) alike, got {tuple(h.shape)}, {tuple(v.shape)}")
    b, d = h.shape
    for t in (vbq, pos) + rows:
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name}: expected ({b},) per-row inputs, got {tuple(t.shape)}")
    for t in (v, vbq, pos) + rows:
        if t.device != h.device:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {h.device})")
    if b < 1:
        raise ValueError(f"{name}: empty batch")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {h.device}")
    return b, d


def _f32(*ts: torch.Tensor):
    return tuple(t.to(torch.float32).contiguous() for t in ts)


def _check_dim(name: str, d: int) -> None:
    if not 1 <= d <= LANES:
        raise ValueError(f"{name}: the kernels take 1 <= D <= {LANES}, got D={d}")


def softmax_ce_fwd(
    h: torch.Tensor, v: torch.Tensor, vbq: torch.Tensor, pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE and LSE; the contract of :func:`softmax_ce_fwd_plain`.
    CUDA tensors launch the forward on the current stream (the split of v
    into tile images, the 3xTF32 ``wgmma`` products with a running max and
    sum per row, the fixed-order combine); CPU tensors take the plain
    version."""
    b, d = _check("softmax_ce_fwd", h, v, vbq, pos)
    if h.device.type == "cpu":
        return softmax_ce_fwd_plain(h, v, vbq, pos)
    _check_dim("softmax_ce_fwd", d)
    dev = h.device
    h, v, vbq = _f32(h, v, vbq)
    pos = pos.to(torch.int64).contiguous()
    lib = _lib()
    n = int(lib.trs_softmax_ce_fwd_scratch(b, d))
    buf = torch.empty((n + 2 * b,), dtype=torch.float32, device=dev)  # scratch, loss, lse
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.trs_softmax_ce_fwd(
            h.data_ptr(), v.data_ptr(), vbq.data_ptr(), pos.data_ptr(), b, d,
            p, p + 4 * n, p + 4 * (n + b), _stream(dev),
        )
    _raise_on(rc, "softmax_ce_fwd")
    softmax_ce_fwd.launches += 1
    return buf[n : n + b], buf[n + b :]


softmax_ce_fwd.launches = 0


def softmax_ce_bwd(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dh, dv, dvb)``; the contract of :func:`softmax_ce_bwd_plain`.
    CUDA tensors launch the one-pass backward (every logit computed once,
    its three products on the tensor cores in 3xTF32) and the fixed-order
    sum of its partials; CPU tensors take the plain version."""
    b, d = _check("softmax_ce_bwd", h, v, vbq, pos, lse, g)
    if h.device.type == "cpu":
        return softmax_ce_bwd_plain(h, v, vbq, pos, lse, g)
    _check_dim("softmax_ce_bwd", d)
    dev = h.device
    h, v, vbq, lse, g = _f32(h, v, vbq, lse, g)
    pos = pos.to(torch.int64).contiguous()
    lib = _lib()
    part = torch.empty((lib.trs_softmax_ce_bwd_scratch(b, d),), dtype=torch.float32, device=dev)
    out = torch.empty((b * (2 * d + 1),), dtype=torch.float32, device=dev)
    dh, dv = out[: b * d].view(b, d), out[b * d : 2 * b * d].view(b, d)
    dvb = out[2 * b * d :]
    with torch.cuda.device(dev):
        rc = lib.trs_softmax_ce_bwd(
            h.data_ptr(), v.data_ptr(), vbq.data_ptr(), pos.data_ptr(), lse.data_ptr(),
            g.data_ptr(), b, d, part.data_ptr(), dh.data_ptr(), dv.data_ptr(),
            dvb.data_ptr(), _stream(dev),
        )
    _raise_on(rc, "softmax_ce_bwd")
    softmax_ce_bwd.launches += 1
    return dh, dv, dvb


softmax_ce_bwd.launches = 0

CeFns = Tuple[Callable[..., Tuple[torch.Tensor, torch.Tensor]], Callable[..., Tuple]]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class InBatchSoftmaxCE(torch.autograd.Function):
    """(B,) per-row CE with the backward of :func:`softmax_ce_bwd`
    (``jax.custom_vjp``, :176-228). ``fns`` replaces the (forward,
    backward) pair, e.g. with the plain versions for a comparison on the
    card."""

    @staticmethod
    def forward(ctx, h, v, vbq, pos, fns: Optional[CeFns] = None):
        fwd, bwd = fns or (softmax_ce_fwd, softmax_ce_bwd)
        loss, lse = fwd(h, v, vbq, pos)
        ctx.save_for_backward(h, v, vbq, pos, lse)
        ctx.bwd = bwd
        return loss

    @staticmethod
    def backward(ctx, g):
        h, v, vbq, pos, lse = ctx.saved_tensors
        dh, dv, dvb = ctx.bwd(h, v, vbq, pos, lse, g.contiguous())
        return dh.to(h.dtype), dv.to(v.dtype), dvb.to(vbq.dtype), None, None


def inbatch_softmax_ce(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    fns: Optional[CeFns] = None,
) -> torch.Tensor:
    """(B,) per-row in-batch softmax CE, single device (:231-237).
    ``vbq = item_bias - logq[pos]``; gradients flow to h, v and vbq."""
    return InBatchSoftmaxCE.apply(h, v, vbq, pos, fns)

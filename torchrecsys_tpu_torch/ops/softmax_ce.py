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

  Both keep the TPU kernels' rectangular contract (``_ce`` :177): Br rows
  (``h``, ``pos``) against Bc columns (``v``, ``vbq``, ``pos_col``) with a
  row offset ``off``, the positive of row r in column ``r + off``. The
  single-device call is the square one (``pos_col`` None: ``pos``, ``off``
  0); :func:`inbatch_softmax_ce_dp` passes a rank's rows against the
  all-gathered batch.

  Given CPU tensors each takes its plain version
  (:func:`softmax_ce_fwd_plain`, :func:`softmax_ce_bwd_plain`); given CUDA
  tensors it launches its kernels or raises. Each counts its launches in
  ``.launches``.
- :class:`InBatchSoftmaxCE` is the ``jax.custom_vjp`` (:176-228) as a
  ``torch.autograd.Function``; :func:`inbatch_softmax_ce` its entry.
- :func:`inbatch_softmax_rows_plain` is the XLA formulation, taken for
  ``d > 128`` (:func:`softmax_kernel_applicable`), as the JAX package does.
- :func:`inbatch_softmax_ce_dp` (:240-264) is the data-parallel wrapper on
  a mesh: a rank's B/n rows against the batch's B columns, all-gathered
  over ``data`` with their gradients flowing back (parallel/mesh.py).

The matmuls are f32 (IEEE on the card: the plain versions switch TF32 off
around their products; both kernels' products are 3xTF32 on the tensor
cores, f32-accurate to ~2^-21).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

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


def _dup_mask(
    pos: torch.Tensor, pos_col: Optional[torch.Tensor] = None, off: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Br, Bc) accidental-hit mask (same positive, off the diagonal) and the
    diagonal ``c == r + off``; square (``pos_col`` = ``pos``) by default."""
    if pos_col is None:
        pos_col = pos
    br, bc = pos.shape[0], pos_col.shape[0]
    eye = (torch.arange(bc, device=pos.device)[None, :]
           == torch.arange(br, device=pos.device)[:, None] + off)
    return (pos_col[None, :] == pos[:, None]) & ~eye, eye


def inbatch_softmax_rows_plain(
    h: torch.Tensor,
    v: torch.Tensor,
    vb: torch.Tensor,
    pos: torch.Tensor,
    logq: Optional[torch.Tensor],
    pos_col: Optional[torch.Tensor] = None,
    off: int = 0,
) -> torch.Tensor:
    """(B,) per-row in-batch CE, the XLA formulation (trainer.py:107-139):
    one ``h @ v.T``, the logQ correction of every column, duplicates masked
    to -inf off the diagonal, logsumexp minus the diagonal label.
    Differentiable by torch autograd. With ``pos_col`` the rows ``h``/``pos``
    score against columns ``v``/``vb``/``pos_col``, row r's label in column
    ``r + off`` (a mesh rank's rows against the whole batch)."""
    with _ieee_f32_matmul(h.device):
        logits = (h @ v.T).float() + vb.float()[None, :]
    if logq is not None:
        logits = logits - logq[pos if pos_col is None else pos_col][None, :]
    dup, eye = _dup_mask(pos, pos_col, off)
    logits = logits.masked_fill(dup, -torch.inf)
    return torch.logsumexp(logits, dim=1) - logits[eye]


def _masked_logits(h, v, vbq, pos, pos_col=None, off=0) -> Tuple[torch.Tensor, torch.Tensor]:
    with _ieee_f32_matmul(h.device):
        s = h.float() @ v.float().T
    dup, eye = _dup_mask(pos, pos_col, off)
    return (s + vbq.float()[None, :]).masked_fill(dup, -torch.inf), eye


def softmax_ce_fwd_plain(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    pos_col: Optional[torch.Tensor] = None,
    off: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's contract: ``(loss (Br,), lse (Br,))`` f32 for
    rows ``h``/``pos`` against columns ``v``/``vbq``/``pos_col`` (default
    ``pos``), the label of row r in column ``r + off``."""
    s, eye = _masked_logits(h, v, vbq, pos, pos_col, off)
    lse = torch.logsumexp(s, dim=1)
    return lse - s[eye], lse


def softmax_ce_bwd_plain(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    pos_col: Optional[torch.Tensor] = None,
    off: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract: with ``dlog = g * (softmax -
    onehot)`` (masked logits have probability 0; the one-hot at ``r +
    off``), ``(dh = dlog @ v (Br, D), dv = dlog.T @ h (Bc, D), dvb =
    dlog.sum(0) (Bc,))``, f32."""
    s, eye = _masked_logits(h, v, vbq, pos, pos_col, off)
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
        lib.trs_softmax_ce_fwd_scratch.argtypes = [_CI] * 3
        lib.trs_softmax_ce_fwd_scratch.restype = ctypes.c_longlong
        lib.trs_softmax_ce_bwd_scratch.argtypes = [_CI] * 3
        lib.trs_softmax_ce_bwd_scratch.restype = ctypes.c_longlong
        lib.trs_softmax_ce_fwd.argtypes = [_VP] * 5 + [_CI] * 4 + [_VP] * 4
        lib.trs_softmax_ce_fwd.restype = _CI
        lib.trs_softmax_ce_bwd.argtypes = [_VP] * 7 + [_CI] * 4 + [_VP] * 5
        lib.trs_softmax_ce_bwd.restype = _CI
        lib._trs_bound = True
    return lib


def _check(name: str, h, v, vbq, pos, pos_col, off, *rows: torch.Tensor) -> Tuple[int, int, int, torch.Tensor]:
    """Shapes and devices of the CE inputs; returns (Br, Bc, D, pos_col).
    Square (``pos_col`` None): h and v alike, ``pos_col = pos``, off 0."""
    square = pos_col is None
    if h.dim() != 2 or v.dim() != 2 or h.shape[1] != v.shape[1] or (square and v.shape != h.shape):
        raise ValueError(f"{name}: h (Br, D) and v (Bc, D) must be alike in D (and in B without "
                         f"pos_col), got {tuple(h.shape)}, {tuple(v.shape)}")
    br, d = h.shape
    bc = v.shape[0]
    if square:
        pos_col = pos
        if off:
            raise ValueError(f"{name}: off={off} needs pos_col")
    for want, ts in ((br, (pos,) + rows), (bc, (vbq, pos_col))):
        for t in ts:
            if tuple(t.shape) != (want,):
                raise ValueError(f"{name}: expected ({want},) per-row inputs, got {tuple(t.shape)}")
    for t in (v, vbq, pos, pos_col) + rows:
        if t.device != h.device:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {h.device})")
    if br < 1 or bc < 1:
        raise ValueError(f"{name}: empty batch")
    if not 0 <= off <= bc - br:
        raise ValueError(f"{name}: off={off} outside [0, {bc - br}] for {br} rows against {bc} columns")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {h.device}")
    return br, bc, d, pos_col


def _f32(*ts: torch.Tensor):
    return tuple(t.to(torch.float32).contiguous() for t in ts)


def _check_dim(name: str, d: int) -> None:
    if not 1 <= d <= LANES:
        raise ValueError(f"{name}: the kernels take 1 <= D <= {LANES}, got D={d}")


def _ids(*ts: torch.Tensor):
    return tuple(t.to(torch.int64).contiguous() for t in ts)


def softmax_ce_fwd(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    pos_col: Optional[torch.Tensor] = None,
    off: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row CE and LSE; the contract of :func:`softmax_ce_fwd_plain`.
    CUDA tensors launch the forward on the current stream (the split of v
    into tile images, the 3xTF32 ``wgmma`` products with a running max and
    sum per row, the fixed-order combine); CPU tensors take the plain
    version. The square call and a rank's rectangular one are the same
    kernels."""
    br, bc, d, pos_col = _check("softmax_ce_fwd", h, v, vbq, pos, pos_col, off)
    if h.device.type == "cpu":
        return softmax_ce_fwd_plain(h, v, vbq, pos, pos_col, off)
    _check_dim("softmax_ce_fwd", d)
    dev = h.device
    h, v, vbq = _f32(h, v, vbq)
    pos, pos_col = _ids(pos, pos_col)
    lib = _lib()
    n = int(lib.trs_softmax_ce_fwd_scratch(br, bc, d))
    buf = torch.empty((n + 2 * br,), dtype=torch.float32, device=dev)  # scratch, loss, lse
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.trs_softmax_ce_fwd(
            h.data_ptr(), v.data_ptr(), vbq.data_ptr(), pos.data_ptr(), pos_col.data_ptr(),
            br, bc, int(off), d, p, p + 4 * n, p + 4 * (n + br), _stream(dev),
        )
    _raise_on(rc, "softmax_ce_fwd")
    softmax_ce_fwd.launches += 1
    return buf[n : n + br], buf[n + br :]


softmax_ce_fwd.launches = 0


def softmax_ce_bwd(
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    pos_col: Optional[torch.Tensor] = None,
    off: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dh, dv, dvb)``; the contract of :func:`softmax_ce_bwd_plain`.
    CUDA tensors launch the one-pass backward (every logit computed once,
    its three products on the tensor cores in 3xTF32) and the fixed-order
    sum of its partials; CPU tensors take the plain version."""
    br, bc, d, pos_col = _check("softmax_ce_bwd", h, v, vbq, pos, pos_col, off, lse, g)
    if h.device.type == "cpu":
        return softmax_ce_bwd_plain(h, v, vbq, pos, lse, g, pos_col, off)
    _check_dim("softmax_ce_bwd", d)
    dev = h.device
    h, v, vbq, lse, g = _f32(h, v, vbq, lse, g)
    pos, pos_col = _ids(pos, pos_col)
    lib = _lib()
    part = torch.empty((lib.trs_softmax_ce_bwd_scratch(br, bc, d),), dtype=torch.float32, device=dev)
    out = torch.empty(((br + bc) * d + bc,), dtype=torch.float32, device=dev)
    dh, dv = out[: br * d].view(br, d), out[br * d : (br + bc) * d].view(bc, d)
    dvb = out[(br + bc) * d :]
    with torch.cuda.device(dev):
        rc = lib.trs_softmax_ce_bwd(
            h.data_ptr(), v.data_ptr(), vbq.data_ptr(), pos.data_ptr(), pos_col.data_ptr(),
            lse.data_ptr(), g.data_ptr(), br, bc, int(off), d, part.data_ptr(), dh.data_ptr(),
            dv.data_ptr(), dvb.data_ptr(), _stream(dev),
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
    """(Br,) per-row CE with the backward of :func:`softmax_ce_bwd`
    (``jax.custom_vjp``, :176-228). ``fns`` replaces the (forward,
    backward) pair, e.g. with the plain versions for a comparison on the
    card; ``pos_col``/``off`` (the rectangular call) are passed to them
    only when given."""

    @staticmethod
    def forward(ctx, h, v, vbq, pos, fns: Optional[CeFns] = None, pos_col=None, off: int = 0):
        fwd, bwd = fns or (softmax_ce_fwd, softmax_ce_bwd)
        rect = () if pos_col is None else (pos_col, off)
        loss, lse = fwd(h, v, vbq, pos, *rect)
        ctx.save_for_backward(h, v, vbq, pos, lse, *rect[:1])
        ctx.bwd, ctx.off = bwd, off
        return loss

    @staticmethod
    def backward(ctx, g):
        h, v, vbq, pos, lse, *pc = ctx.saved_tensors
        rect = () if not pc else (pc[0], ctx.off)
        dh, dv, dvb = ctx.bwd(h, v, vbq, pos, lse, g.contiguous(), *rect)
        return dh.to(h.dtype), dv.to(v.dtype), dvb.to(vbq.dtype), None, None, None, None


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


def inbatch_softmax_ce_dp(
    mesh,
    h: torch.Tensor,
    v: torch.Tensor,
    vbq: torch.Tensor,
    pos: torch.Tensor,
    fns: Optional[CeFns] = None,
    rows: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Data-parallel in-batch CE on a mesh (:240-264): this rank's (B/n,)
    per-row losses of its rows ``h``/``pos`` against the whole batch's
    columns. ``v``, ``vbq`` and ``pos`` are all-gathered over ``data``
    (:func:`parallel.mesh.all_gather`, whose backward all-reduces the
    cotangent and takes this rank's slice, so ``dv`` and ``dvb`` sum every
    rank's rows) and the kernels run at ``off`` = the rows of the ranks
    before this one (``rows``: every rank's row count; default even): the
    single-device call on the whole batch, row block by row block."""
    from torchrecsys_tpu_torch.parallel.mesh import all_gather

    v_g = all_gather(v, mesh, "data", rows)
    vbq_g = all_gather(vbq, mesh, "data", rows)
    pos_g = all_gather(pos, mesh, "data", rows)
    off = sum(rows[: mesh.data_rank]) if rows is not None else mesh.data_rank * h.shape[0]
    return InBatchSoftmaxCE.apply(h, v_g, vbq_g, pos, fns, pos_g, off)

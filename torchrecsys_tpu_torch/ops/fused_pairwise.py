"""The fused pairwise train step of the factorization models: a
hand-written Hopper kernel and its plain version.

Port of ``torchrecsys_tpu/ops/fused_pairwise.py`` (single device, Linear).
Per batch:

    [kernel: read packed rows by id -> score pos|neg -> loss -> row grads
    -> rowwise-adagrad deltas -> add the update rows in place]

**Packed epoch layout** (:13-22). For one epoch each side's state lives in
one ``(rows, 128)`` f32 table, one row per id:

    col 0..D-1 : factor vector            (D = n_factors)
    col D      : rowwise-adagrad accumulator of the vector
    col D+1    : bias
    col D+2    : accumulator of the bias
    rest       : zero padding up to 128 lanes

so one row gather brings the kernel everything about an id and one row
scatter-add applies both the parameter delta and the accumulator
increment. Per-row loss weights come from the batch, never from a table
lane.

- :func:`fused_pairwise_step` (:367-412) and
  :func:`fused_pairwise_step_meta` (:811-864, Linear) update the packed
  tables IN PLACE and return them with the step's loss as a device scalar
  (or write it into ``loss_out[loss_index]``). Given CUDA tables each is
  ONE call of the step kernel (``csrc/fused_pairwise.cu``, the redesign of
  ``_pairwise_kernel`` :100-243 for the card: the rows read by id, the
  metadata composite and deltas, the updates added in place, the loss
  stored; two launches); ``.launches`` counts those calls. Given CPU
  tables they run their plain versions (:func:`fused_pairwise_step_plain`,
  :func:`fused_pairwise_step_meta_plain`: gather, row math, ``index_add_``),
  which a check on the card calls directly. The scalars ``inv``, ``lr``,
  ``margin`` and ``eps`` are launch arguments, so the caller passes host
  values and no step syncs.
- :func:`pairwise_updates_rows` keeps the row-level contract of
  ``_pairwise_updates_rows`` (:279-357): packed rows in, update rows and
  the loss sum out, no scatter, what the FM metadata step and the mesh
  wrappers need. It launches ``fused_pairwise_kernel`` (the same row math)
  on CUDA tensors and computes :func:`pairwise_updates_rows_plain` on CPU
  ones; ``pairwise_updates_rows.launches`` counts its launches.
- ``fused_pairwise_step_meta(..., meta_lin=..., fm=True)`` is FM's
  metadata step (``_meta_step_core`` with ``fm=True``, :660-801), as the
  JAX package splits it: the composite rows (the per-item constant and
  the linear-metadata sums in the bias lane) are gathered and formed in
  torch, ONE launch of the row-level kernel (``emit_g``, ``item_upd=False``)
  runs the row math, and the item, metadata and linear-metadata update
  rows are formed in torch from the emitted g lanes (d score / d field =
  g (u + q - v_field) differs per field, so the step kernel's Linear
  deltas g u never serve FM), then scattered with ``index_add_``. The
  step wrappers record the step kernel's variant index of their last
  launch in ``.variant`` (``pairwise_updates_rows.variant`` the row-level
  kernel's), so a check can tell the bf16 variants were the ones run.
- The mesh wrappers (:415-641, :867-1034), for one rank of a
  ('data', 'model') mesh (parallel/mesh.py) holding its ``data`` shard of
  the batch: :func:`fused_pairwise_step_dp` / :func:`fused_pairwise_step_tp`
  (B1/B2) and :func:`fused_pairwise_step_meta_dp` /
  :func:`fused_pairwise_step_meta_tp` (B3/B4, Linear and FM). Each gathers
  its rows (tp: masked local gather + psum over ``model``, exact), launches
  the row-level kernel once on them (FM's metadata step and Linear's
  alike: the step kernel scatters in place, so its updates could not be
  shared), all-gathers the update rows and ids over ``data`` (one
  collective per dtype) and scatters the whole batch's updates: every
  replica the same rows (dp), each rank the rows of its shard (tp), in the
  fixed order of parallel/embedding.py::scatter_add_rows, so replicas stay
  bitwise equal. The loss normalizer is the global weight sum, or
  ``1/(B_local n_data)`` without weights.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.parallel.embedding import scatter_add_rows, sharded_lookup, sharded_scatter_add
from torchrecsys_tpu_torch.parallel.mesh import all_gather_many, all_reduce_

LANES = 128
SUPPORTED_LOSSES = ("hinge", "bpr", "logistic")
_LOSS_CODE = {"hinge": 0, "bpr": 1, "logistic": 2}
_VP, _CI, _CF, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_MAX_FEATURES = 16  # metadata features the step kernel takes (kMaxFeatures)


# ---------------------------------------------------------------------------
# packing (:79-92, :1088-1103)
# ---------------------------------------------------------------------------


def pack_side(vec_aug: torch.Tensor, bias_aug: torch.Tensor) -> torch.Tensor:
    """(R, D+1) augmented vector table + (R, 2) augmented bias table ->
    (R, 128) packed table."""
    r, d1 = vec_aug.shape
    d = d1 - 1
    out = torch.zeros((r, LANES), dtype=torch.float32, device=vec_aug.device)
    out[:, : d + 1] = vec_aug
    out[:, d + 1 : d + 3] = bias_aug
    return out


def unpack_side(packed: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_side` -> (vec_aug (R, D+1), bias_aug (R, 2))."""
    return packed[:, : d + 1], packed[:, d + 1 : d + 3]


def pack_tables(
    aug_tables: Mapping[str, torch.Tensor], pack: Mapping[str, Tuple[str, str]]
) -> Dict[str, torch.Tensor]:
    """Augmented per-table dict -> {"user": (Ru, 128), "item": (Ri, 128)}."""
    return {
        side: pack_side(aug_tables[vec_name], aug_tables[bias_name])
        for side, (vec_name, bias_name) in pack.items()
    }


def unpack_tables(
    packed: Mapping[str, torch.Tensor], pack: Mapping[str, Tuple[str, str]], d: int
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_tables` -> augmented per-table dict."""
    out: Dict[str, torch.Tensor] = {}
    for side, (vec_name, bias_name) in pack.items():
        out[vec_name], out[bias_name] = unpack_side(packed[side], d)
    return out


# ---------------------------------------------------------------------------
# the step's row math: plain version and kernel wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _inv_d(d: int) -> float:
    """1/d rounded to f32, as the TPU kernel's ``* (1.0 / d)`` applies it."""
    return float(np.float32(1.0 / d))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def pairwise_updates_rows_plain(
    u: torch.Tensor,
    p: torch.Tensor,
    n: torch.Tensor,
    weights: Optional[torch.Tensor],
    inv: float,
    lr: float,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float,
    emit_g: bool = False,
    item_upd: bool = True,
    bf16: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The closed form of ``_pairwise_kernel`` (:149-243) in torch, op for
    op. Returns ``(upd_u (B, 128), upd_items (2B, 128) or None, loss_sum
    ())``: ``upd_items`` holds the positive rows' updates then the negative
    rows' (None with ``item_upd=False``)."""
    f32 = torch.float32
    col = torch.arange(LANES, device=u.device)[None, :]
    vmask = (col < d).to(f32)

    def rnd(x):  # bf16 rounding of score-path values (AMP)
        return x.to(torch.bfloat16).to(f32) if bf16 else x

    uv, pv, nv = rnd(u * vmask), rnd(p * vmask), rnd(n * vmask)

    def lane(a, c):  # (B, 1) column c
        return a[:, c : c + 1]

    acc_u, b_u, bacc_u = lane(u, d), rnd(lane(u, d + 1)), lane(u, d + 2)
    acc_p, b_p, bacc_p = lane(p, d), rnd(lane(p, d + 1)), lane(p, d + 2)
    acc_n, b_n, bacc_n = lane(n, d), rnd(lane(n, d + 1)), lane(n, d + 2)

    raw_p = torch.sum(uv * pv, dim=1, keepdim=True) + b_u + b_p
    raw_n = torch.sum(uv * nv, dim=1, keepdim=True) + b_u + b_n
    s_p, s_n = (torch.sigmoid(raw_p), torch.sigmoid(raw_n)) if sigmoid else (raw_p, raw_n)

    # host scalars enter each op as f32 values (no host-to-device copy)
    inv_t, lr_t, margin_t, eps_t = (float(np.float32(x)) for x in (inv, lr, margin, eps))
    if loss_kind == "hinge":
        diff = s_n - s_p + margin_t
        l = torch.clamp_min(diff, 0.0)
        act = (diff > 0.0).to(f32) + 0.5 * (diff == 0.0).to(f32)
        dp, dn = -act, act
    elif loss_kind == "bpr":
        diff = s_n - s_p
        l = _softplus(diff)
        sig = torch.sigmoid(diff)
        dp, dn = -sig, sig
    elif loss_kind == "logistic":
        l = -0.5 * (-_softplus(-s_p) + -_softplus(s_n))
        dp = -0.5 * torch.sigmoid(-s_p)
        dn = 0.5 * torch.sigmoid(s_n)
    else:
        raise ValueError(f"unsupported loss {loss_kind!r}; expected one of {SUPPORTED_LOSSES}")
    if sigmoid:
        dp = dp * s_p * (1.0 - s_p)
        dn = dn * s_n * (1.0 - s_n)

    if weights is not None:
        w = weights.to(f32)[:, None]
        gp, gn = dp * (w * inv_t), dn * (w * inv_t)
        loss_sum = torch.sum(l * w)
    else:
        gp, gn = dp * inv_t, dn * inv_t
        loss_sum = torch.sum(l)

    inv_d = _inv_d(d)

    def upd(gvec, acc, gb, bacc):
        msq = torch.sum(gvec * gvec, dim=1, keepdim=True) * inv_d
        dvec = gvec * torch.rsqrt(acc + msq + eps_t)
        dbias = gb * torch.rsqrt(bacc + gb * gb + eps_t)
        out = -lr_t * dvec
        out = out + torch.where(col == d, msq, 0.0)
        out = out + torch.where(col == d + 1, -lr_t * dbias, 0.0)
        return out + torch.where(col == d + 2, gb * gb, 0.0)

    uo = upd(gp * pv + gn * nv, acc_u, gp + gn, bacc_u)
    if emit_g:
        uo = uo + torch.where(col == d + 4, gp, 0.0) + torch.where(col == d + 5, gn, 0.0)
    items = None
    if item_upd:
        items = torch.cat([upd(gp * uv, acc_p, gp, bacc_p), upd(gn * uv, acc_n, gn, bacc_n)])
    return uo, items, loss_sum


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_pairwise.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_fused_pairwise_blocks.argtypes = [_CI]
        lib.trs_fused_pairwise_blocks.restype = _CI
        lib.trs_fused_pairwise.argtypes = (
            [_CI] * 6 + [_VP] * 4 + [_CI] * 2 + [_CF] * 5 + [_VP] * 6
        )
        lib.trs_fused_pairwise.restype = _CI
        lib.trs_fused_pairwise_step_scratch.argtypes = [_CI] * 4
        lib.trs_fused_pairwise_step_scratch.restype = _LL
        lib.trs_fused_pairwise_step.argtypes = (
            [_CI] * 5 + [_VP, _LL, _VP, _LL] + [_VP] * 4 + [_CI] * 2 + [_CF] * 5 + [_CI] * 2
            + [_VP, _VP, _LL] + [_VP] * 5
        )
        lib.trs_fused_pairwise_step.restype = _CI
        lib.trs_fused_pairwise_empty.argtypes = [_CI, _VP]
        lib.trs_fused_pairwise_empty.restype = _CI
        lib._trs_bound = True
    return lib


def _check_rows(name: str, d: int, emit_g: bool, *rows: torch.Tensor) -> None:
    dev = rows[0].device
    b = rows[0].shape[0]
    for t in rows:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {dev})")
        if t.dim() != 2 or tuple(t.shape) != (b, LANES) or t.dtype != torch.float32:
            raise ValueError(
                f"{name}: expected ({b}, {LANES}) float32 packed rows, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
    if b < 1:
        raise ValueError(f"{name}: empty batch")
    if not 1 <= d <= LANES - (6 if emit_g else 4):
        raise ValueError(
            f"{name}: d={d} does not fit the packed layout (d <= {LANES - 4}, "
            f"{LANES - 6} with emit_g)"
        )


def pairwise_updates_rows(
    u: torch.Tensor,
    p: torch.Tensor,
    n: torch.Tensor,
    weights: Optional[torch.Tensor],
    inv: float,
    lr: float,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float,
    emit_g: bool = False,
    item_upd: bool = True,
    bf16: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Rowwise-adagrad update rows and the weighted loss sum of one batch of
    packed rows; the contract of :func:`pairwise_updates_rows_plain`.

    CUDA tensors launch ``fused_pairwise_kernel`` (one warp per row) and
    its fixed-order loss sum on the current stream; CPU tensors take the
    plain version. ``weights`` given turns on the weighted variant
    (``use_w``), as in the JAX package."""
    _check_rows("pairwise_updates_rows", d, emit_g, u, p, n)
    if loss_kind not in _LOSS_CODE:
        raise ValueError(f"unsupported loss {loss_kind!r}; expected one of {SUPPORTED_LOSSES}")
    kw = dict(d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps,
              emit_g=emit_g, item_upd=item_upd, bf16=bf16)
    dev = u.device
    if dev.type == "cpu":
        return pairwise_updates_rows_plain(u, p, n, weights, inv, lr, **kw)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_updates_rows: tensors must be on CPU or CUDA, got {dev}")
    b = u.shape[0]
    # the kernel moves rows as float4: contiguous and 16-byte aligned
    u, p, n = (t.contiguous() for t in (u, p, n))
    u, p, n = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (u, p, n))
    w = None
    if weights is not None:
        if weights.device != dev or tuple(weights.shape) != (b,):
            raise ValueError(f"pairwise_updates_rows: weights must be ({b},) on {dev}")
        w = weights.to(torch.float32).contiguous()
    lib = _lib()
    blocks = lib.trs_fused_pairwise_blocks(b)
    rows = (3 if item_upd else 1) * b * LANES
    # one allocation: update rows, then the per-block loss sums, then the loss
    buf = torch.empty((rows + blocks + 1,), dtype=torch.float32, device=dev)
    uo = buf[: b * LANES].view(b, LANES)
    items = buf[b * LANES : rows].view(2 * b, LANES) if item_upd else None
    ptr = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.trs_fused_pairwise(
            _LOSS_CODE[loss_kind], int(sigmoid), int(w is not None), int(emit_g),
            int(item_upd), int(bf16),
            u.data_ptr(), p.data_ptr(), n.data_ptr(), w.data_ptr() if w is not None else None,
            b, d, _inv_d(d), float(inv), float(lr), float(margin), float(eps),
            ptr,
            ptr + 4 * b * LANES if item_upd else None,
            ptr + 8 * b * LANES if item_upd else None,
            ptr + 4 * rows, ptr + 4 * (rows + blocks),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    loss_sum = buf[rows + blocks]
    if rc != 0:
        raise RuntimeError(f"pairwise_updates_rows: CUDA launch failed with cudaError {rc}")
    pairwise_updates_rows.launches += 1
    pairwise_updates_rows.variant = row_variant(loss_kind, sigmoid, w is not None, emit_g, item_upd, bf16)
    return uo, items, loss_sum


pairwise_updates_rows.launches = 0
pairwise_updates_rows.variant = None


def row_variant(loss_kind: str, sigmoid: bool, use_w: bool, emit_g: bool, item_upd: bool, bf16: bool) -> int:
    """The row-level kernel's variant index, as ``trs_fused_pairwise``
    forms it: loss * 32 + sigmoid * 16 + use_w * 8 + emit_g * 4 +
    item_upd * 2 + bf16."""
    return _LOSS_CODE[loss_kind] * 32 + 16 * sigmoid + 8 * use_w + 4 * emit_g + 2 * item_upd + bf16


# ---------------------------------------------------------------------------
# steps: the plain composition and the step kernel
# ---------------------------------------------------------------------------


def step_inv(b: int, weights: Optional[torch.Tensor], weight_sum: Optional[float] = None) -> float:
    """The loss normalizer as an f32 value on the host: ``1/b`` without
    weights, else ``1 / max(sum(w), 1)``. ``weight_sum`` saves the device
    sum (a sync) when the caller knows it, as the trainer does."""
    if weights is None:
        return _inv_of(b, None)
    if weight_sum is None:
        weight_sum = float(weights.to(torch.float32).sum())
    return _inv_of(b, weight_sum)


@functools.lru_cache(maxsize=256)
def _inv_of(b: int, weight_sum: Optional[float]) -> float:
    if weight_sum is None:
        return float(np.float32(1.0 / b))
    return float(np.float32(1.0) / np.maximum(np.float32(weight_sum), np.float32(1.0)))


def _pairwise_updates(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    inv: float,
    lr: float,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Gather packed rows (one gather for the user rows, one for the
    positive then negative item rows) and run the row math. Returns
    ``(iids (2B,), upd_u, upd_items, loss_sum)``."""
    b = user_ids.shape[0]
    iids = torch.cat([pos_ids, neg_ids])
    u = user_pk.index_select(0, user_ids)
    pn = item_pk.index_select(0, iids)
    upd_u, upd_items, loss_sum = pairwise_updates_rows_plain(u, pn[:b], pn[b:], weights, inv, lr, **kw)
    return iids, upd_u, upd_items, loss_sum


def _put_loss(loss: torch.Tensor, loss_out: Optional[torch.Tensor], loss_index: int) -> torch.Tensor:
    if loss_out is None:
        return loss
    loss_out[loss_index] = loss
    return loss_out[loss_index]


def fused_pairwise_step_plain(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float = 1e-10,
    bf16: bool = False,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step kernel's plain version (:367-412), op for op: gather ->
    row math -> two ``index_add_`` scatters (user rows; item rows,
    positives then negatives) -> ``loss_sum * inv``."""
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    iids, upd_u, upd_items, loss_sum = _pairwise_updates(
        user_pk, item_pk, user_ids, pos_ids, neg_ids, weights, inv, lr,
        d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps, bf16=bf16,
    )
    user_pk.index_add_(0, user_ids, upd_u)
    item_pk.index_add_(0, iids, upd_items)
    return user_pk, item_pk, _put_loss(loss_sum * inv, loss_out, loss_index)


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (any shape) of a whole table."""
    return table[ids]


def _meta_step_core(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    inv: float,
    lr: float,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool,
    eps: float,
    rows_fn: Callable = pairwise_updates_rows_plain,
    gather: Callable = _take,
):
    """Composite-row step + the metadata updates, Linear (:660-801 with
    ``fm=False``); ``rows_fn`` runs the row math (the plain version, or
    the row-level kernel on a mesh), ``gather`` reads rows of a table (a
    sharded lookup under a row-sharded mesh).

    The item rows the row math sees are composite: their vector lanes hold
    ``item_vec + sum_f masked_sum(meta_f)``, so the score, the loss and the
    user update are the model's. For Linear d score / d item_vec = d score
    / d meta slot = g * u, so the item update rows (formed against the
    item's own accumulator lanes, which composition leaves alone) are
    exact, and each metadata slot's rowwise-adagrad delta is formed here
    from the ``gp``/``gn`` the row math emits in lanes d+4, d+5.

    Returns ``(upd_u (B, 128), iids (2B,), item_rows (2B, 128),
    meta_deltas [F x (ids (2BW,), rows (2BW, D+1))], loss_sum)``."""
    b = user_ids.shape[0]
    f32 = torch.float32
    iids = torch.cat([pos_ids, neg_ids])
    u = gather(user_pk, user_ids)
    pn = gather(item_pk, iids)  # (2B, 128), composited in place below
    mids = meta_ids.index_select(0, iids)  # (2B, F, W)
    mm = meta_mask.index_select(0, iids).to(f32)
    rows = []
    csum = None
    for f in range(len(meta_vec)):
        r = gather(meta_vec[f], mids[:, f, :])  # (2B, W, D+1)
        rows.append(r)
        c = torch.sum(r[..., :d] * mm[:, f, :, None], dim=1)  # masked_sum
        csum = c if csum is None else csum + c
    if csum is not None:
        pn[:, :d] += csum

    upd_u, item_rows, loss_sum = rows_fn(
        u, pn[:b], pn[b:], weights, inv, lr,
        d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps,
        emit_g=True, item_upd=True, bf16=bf16,
    )
    g2 = torch.cat([upd_u[:, d + 4], upd_u[:, d + 5]])[:, None]  # (2B, 1) gp then gn
    uvec = u[:, :d]
    if bf16:  # grads form on bf16-rounded vectors, like the XLA step
        uvec = uvec.to(torch.bfloat16).to(f32)
    base = g2 * torch.cat([uvec, uvec])  # (2B, d): d score / d meta slot

    lr_t, eps_t, inv_d = float(np.float32(lr)), float(np.float32(eps)), _inv_d(d)
    meta_deltas = []
    for f, r in enumerate(rows):
        g = (base[:, None, :] * mm[:, f, :, None]).reshape(-1, d)  # (2BW, d)
        acc = r[..., d].reshape(-1)
        msq = torch.sum(g * g, dim=1) * inv_d
        delta = torch.cat([-lr_t * g * torch.rsqrt(acc + msq + eps_t)[:, None], msq[:, None]], dim=1)
        meta_deltas.append((mids[:, f, :].reshape(-1), delta))
    return upd_u, iids, item_rows, meta_deltas, loss_sum


def fused_pairwise_step_meta_plain(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool = False,
    eps: float = 1e-10,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
    meta_lin: Optional[Sequence[torch.Tensor]] = None,
    fm: bool = False,
):
    """The metadata step's plain version (:811-864), op for op: gathers,
    the composite, the row math, the metadata deltas, one ``index_add_``
    per table. ``fm=True`` takes FM's step (:func:`_fm_meta_step_core`
    around :func:`pairwise_updates_rows_plain`) and updates the augmented
    (Rf, 2) linear-metadata tables ``meta_lin`` in place too."""
    if fm:
        return _fm_meta_step(
            pairwise_updates_rows_plain, user_pk, item_pk, meta_vec, meta_lin, meta_ids, meta_mask,
            user_ids, pos_ids, neg_ids, weights, lr, d=d, margin=margin, loss_kind=loss_kind,
            sigmoid=sigmoid, bf16=bf16, eps=eps, weight_sum=weight_sum, loss_out=loss_out,
            loss_index=loss_index,
        )
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    upd_u, iids, item_rows, meta_deltas, loss_sum = _meta_step_core(
        user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids, neg_ids,
        weights, inv, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid,
        bf16=bf16, eps=eps,
    )
    user_pk.index_add_(0, user_ids, upd_u)
    item_pk.index_add_(0, iids, item_rows)
    for table, (ids, delta) in zip(meta_vec, meta_deltas):
        table.index_add_(0, ids, delta)
    return user_pk, item_pk, meta_vec, _put_loss(loss_sum * inv, loss_out, loss_index)


def _packed_update_rows(gvec, gb, acc, bacc, lr_t: float, d: int, eps_t: float) -> torch.Tensor:
    """The row math's ``upd`` for one occurrence per row (:644-658): (B, d)
    vector grads, (B,) bias grads and the pre-step accumulators -> (B, 128)
    packed update rows (deltas and accumulator increments)."""
    msq = torch.sum(gvec * gvec, dim=1) * _inv_d(d)
    out = torch.zeros((gvec.shape[0], LANES), dtype=torch.float32, device=gvec.device)
    out[:, :d] = -lr_t * gvec * torch.rsqrt(acc + msq + eps_t)[:, None]
    out[:, d] = msq
    out[:, d + 1] = -lr_t * gb * torch.rsqrt(bacc + gb * gb + eps_t)
    out[:, d + 2] = gb * gb
    return out


def _fm_meta_step_core(
    rows_fn: Callable,
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_lin: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    inv: float,
    lr: float,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool,
    eps: float,
    gather: Callable = _take,
):
    """FM's composite-row step (:660-801 with ``fm=True``); ``rows_fn`` is
    :func:`pairwise_updates_rows` or its plain version, ``gather`` as in
    :func:`_meta_step_core`.

    The rows the row math sees are composite: vector lanes ``q = i +
    sum_f c_f`` (``c_f`` the masked sum of field f's rows), bias lane ``b_i
    + 0.5(|q|^2 - |i|^2 - sum_f |c_f|^2) + sum_f masked_sum(linear_meta_f)``,
    so ``u.q + b_u + b_i`` is the FM score and the loss and the user update
    are the model's. It runs with ``emit_g=True, item_upd=False``; from the
    emitted ``gp``/``gn`` (lanes d+4, d+5) the item rows take ``g (u + q -
    i)`` against the item's own accumulators, each metadata slot ``g (u + q
    - c_f)`` and each linear-metadata slot ``g`` (AMP: on bf16-rounded
    vectors, :750-752). Both sides run as one (2B,) block, positives then
    negatives, the order of JAX's concatenations.

    Returns ``(upd_u (B, 128), iids (2B,), item_rows (2B, 128),
    meta_deltas [F x (ids (2BW,), rows (2BW, D+1))], lin_deltas [F x (ids,
    rows (2BW, 2))], loss_sum)``."""
    b = user_ids.shape[0]
    f32 = torch.float32
    iids = torch.cat([pos_ids, neg_ids])
    u = gather(user_pk, user_ids)
    pn = gather(item_pk, iids)  # (2B, 128): the items' own rows
    mids = meta_ids.index_select(0, iids)  # (2B, F, W)
    mm = meta_mask.index_select(0, iids).to(f32)
    vrows, lrows, c = [], [], []
    for f in range(len(meta_vec)):
        r = gather(meta_vec[f], mids[:, f, :])  # (2B, W, D+1)
        vrows.append(r)
        c.append(torch.sum(r[..., :d] * mm[:, f, :, None], dim=1))  # masked_sum
        lrows.append(gather(meta_lin[f], mids[:, f, :]))  # (2B, W, 2)
    ivec = pn[:, :d]
    q = ivec + sum(c)
    sq = torch.sum(ivec * ivec, dim=1) + sum(torch.sum(cf * cf, dim=1) for cf in c)
    const = 0.5 * (torch.sum(q * q, dim=1) - sq)
    lsum = sum(torch.sum(lr_[..., 0] * mm[:, f, :], dim=1) for f, lr_ in enumerate(lrows))
    comp = pn.clone()
    comp[:, :d] = q
    comp[:, d + 1] += const + lsum

    upd_u, _, loss_sum = rows_fn(
        u, comp[:b], comp[b:], weights, inv, lr,
        d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps,
        emit_g=True, item_upd=False, bf16=bf16,
    )
    g2 = torch.cat([upd_u[:, d + 4], upd_u[:, d + 5]])[:, None]  # (2B, 1) gp then gn

    def rnd(x):  # AMP: grads form on bf16-rounded vectors, like the XLA step
        return x.to(torch.bfloat16).to(f32) if bf16 else x

    uvec = rnd(u[:, :d])
    u2, qr = torch.cat([uvec, uvec]), rnd(q)
    lr_t, eps_t, inv_d = float(np.float32(lr)), float(np.float32(eps)), _inv_d(d)
    item_rows = _packed_update_rows(g2 * (u2 + qr - rnd(ivec)), g2[:, 0], pn[:, d], pn[:, d + 2],
                                    lr_t, d, eps_t)
    meta_deltas, lin_deltas = [], []
    for f in range(len(meta_vec)):
        mf = mm[:, f, :]
        g = ((g2 * (u2 + qr - rnd(c[f])))[:, None, :] * mf[..., None]).reshape(-1, d)  # (2BW, d)
        acc = vrows[f][..., d].reshape(-1)
        msq = torch.sum(g * g, dim=1) * inv_d
        delta = torch.cat([-lr_t * g * torch.rsqrt(acc + msq + eps_t)[:, None], msq[:, None]], dim=1)
        ids = mids[:, f, :].reshape(-1)
        meta_deltas.append((ids, delta))
        gb = (g2 * mf).reshape(-1)
        bacc = lrows[f][..., 1].reshape(-1)
        lin_deltas.append((ids, torch.stack([-lr_t * gb * torch.rsqrt(bacc + gb * gb + eps_t), gb * gb], dim=1)))
    return upd_u, iids, item_rows, meta_deltas, lin_deltas, loss_sum


def _fm_meta_step(rows_fn, user_pk, item_pk, meta_vec, meta_lin, meta_ids, meta_mask, user_ids, pos_ids,
                  neg_ids, weights, lr, *, d, margin, loss_kind, sigmoid, bf16, eps, weight_sum, loss_out,
                  loss_index):
    """:func:`_fm_meta_step_core`, then one ``index_add_`` per table (in
    place) and the loss ``loss_sum * inv`` (:843-864)."""
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    upd_u, iids, item_rows, meta_deltas, lin_deltas, loss_sum = _fm_meta_step_core(
        rows_fn, user_pk, item_pk, meta_vec, meta_lin, meta_ids, meta_mask, user_ids, pos_ids, neg_ids,
        weights, inv, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, bf16=bf16, eps=eps,
    )
    user_pk.index_add_(0, user_ids, upd_u)
    item_pk.index_add_(0, iids, item_rows)
    for table, (ids, delta) in zip(meta_vec, meta_deltas):
        table.index_add_(0, ids, delta)
    for table, (ids, delta) in zip(meta_lin, lin_deltas):
        table.index_add_(0, ids, delta)
    return user_pk, item_pk, meta_vec, _put_loss(loss_sum * inv, loss_out, loss_index)


def _check_tensor(name: str, what: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype,
                  shape: Sequence[Optional[int]]) -> None:
    """``t`` on ``dev``, of ``dtype``, contiguous, with ``shape`` (None: any
    extent), else ValueError."""
    if (t.dtype != dtype or t.dim() != len(shape) or t.device != dev or not t.is_contiguous()
            or any(s is not None and s != x for s, x in zip(shape, t.shape))):
        want = tuple("*" if s is None else s for s in shape)
        raise ValueError(
            f"{name}: {what} must be a contiguous {want} {dtype} tensor on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)")
        )


def _check_step(name, d, loss_kind, user_pk, item_pk, ids, weights, loss_out, loss_index,
                meta=None, meta_lin=None) -> None:
    """The step's inputs, before either path: what the kernel takes, so the
    CPU and the card refuse the same calls. Each tensor is tested in one
    expression; the message is formed only for a bad one."""
    dev = user_pk.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    f32 = torch.float32
    for what, t in (("user_pk", user_pk), ("item_pk", item_pk)):
        if (t.dtype != f32 or t.dim() != 2 or t.shape[1] != LANES or not t.is_contiguous()
                or t.device != dev):
            _check_tensor(name, what, t, dev, f32, (None, LANES))
        if t.data_ptr() % 16:  # the kernel moves rows as float4
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    b = ids[0].shape[0] if ids[0].dim() == 1 else -1
    for what, t in zip(("user_ids", "pos_ids", "neg_ids"), ids):
        if (t.dtype != torch.int64 or t.dim() != 1 or t.shape[0] != b or not t.is_contiguous()
                or t.device != dev):
            _check_tensor(name, what, t, dev, torch.int64, (b,))
    if b < 1:
        raise ValueError(f"{name}: empty batch")
    if weights is not None and (weights.dim() != 1 or weights.shape[0] != b or weights.device != dev):
        raise ValueError(f"{name}: weights must be ({b},) on {dev}")
    if not 1 <= d <= LANES - (6 if meta is not None else 4):
        raise ValueError(
            f"{name}: d={d} does not fit the packed layout (d <= {LANES - 4}, "
            f"{LANES - 6} with metadata)"
        )
    if loss_kind not in _LOSS_CODE:
        raise ValueError(f"unsupported loss {loss_kind!r}; expected one of {SUPPORTED_LOSSES}")
    if loss_out is not None:
        if (loss_out.dtype != f32 or loss_out.dim() != 1 or not loss_out.is_contiguous()
                or loss_out.device != dev):
            _check_tensor(name, "loss_out", loss_out, dev, f32, (None,))
        if not 0 <= loss_index < loss_out.shape[0]:
            raise ValueError(f"{name}: loss_index {loss_index} outside loss_out's {loss_out.shape[0]}")
    if meta is not None:
        meta_vec, meta_ids, meta_mask = meta
        f = len(meta_vec)
        _check_tensor(name, "meta_ids", meta_ids, dev, torch.int64, (None, f, None))
        _check_tensor(name, "meta_mask", meta_mask, dev, torch.bool, tuple(meta_ids.shape))
        for t in meta_vec:
            if t.dtype != f32 or t.dim() != 2 or t.shape[1] != d + 1 or not t.is_contiguous() or t.device != dev:
                _check_tensor(name, "each meta_vec table", t, dev, f32, (None, d + 1))
        if meta_lin is not None:
            if len(meta_lin) != f:
                raise ValueError(f"{name}: {len(meta_lin)} meta_lin tables for {f} features")
            for t in meta_lin:
                _check_tensor(name, "each meta_lin table", t, dev, f32, (None, 2))


def step_variant(loss_kind: str, sigmoid: bool, use_w: bool, bf16: bool, meta: bool) -> int:
    """The step kernel's variant index, as ``trs_fused_pairwise_step``
    forms it: loss * 16 + sigmoid * 8 + use_w * 4 + bf16 * 2 + meta."""
    return _LOSS_CODE[loss_kind] * 16 + 8 * sigmoid + 4 * use_w + 2 * bf16 + meta


@functools.lru_cache(maxsize=64)
def _scratch_floats(meta: bool, b: int, nf: int, nw: int) -> int:
    return _lib().trs_fused_pairwise_step_scratch(int(meta), b, nf, nw)


def _step_args(user_pk, item_pk, ids, w, inv, lr, d, margin, loss_kind, sigmoid, eps, bf16,
               meta, scratch_ptr, out_ptr, stream) -> tuple:
    """The argument tuple of the C entry ``trs_fused_pairwise_step``, in its
    order (``w``: f32 contiguous or None). The ctypes arrays it holds live
    as long as the tuple."""
    nf = nw = n_meta = 0
    mids = mmask = vec_ptrs = row_counts = None
    if meta is not None:
        meta_vec, meta_ids, meta_mask = meta
        n_meta, nf, nw = meta_ids.shape
        mids, mmask = meta_ids.data_ptr(), meta_mask.data_ptr()
        vec_ptrs = (ctypes.c_void_p * nf)(*(t.data_ptr() for t in meta_vec))
        row_counts = (ctypes.c_longlong * nf)(*(t.shape[0] for t in meta_vec))
    return (
        _LOSS_CODE[loss_kind], int(sigmoid), int(w is not None), int(bf16), int(meta is not None),
        user_pk.data_ptr(), user_pk.shape[0], item_pk.data_ptr(), item_pk.shape[0],
        ids[0].data_ptr(), ids[1].data_ptr(), ids[2].data_ptr(),
        w.data_ptr() if w is not None else None,
        ids[0].shape[0], d, _inv_d(d), inv, float(lr), float(margin), float(eps),
        nf, nw, mids, mmask, n_meta, vec_ptrs, row_counts, scratch_ptr, out_ptr, stream,
    )


def _launch_step(name, user_pk, item_pk, ids, weights, inv, lr, d, margin, loss_kind, sigmoid,
                 eps, bf16, loss_out, loss_index, meta=None) -> torch.Tensor:
    """Launch the step kernel on the current stream (checked inputs).
    Returns the loss: ``loss_out[loss_index]`` or a fresh device scalar."""
    dev = user_pk.device
    b = ids[0].shape[0]
    w = weights
    if w is not None and (w.dtype != torch.float32 or not w.is_contiguous()):
        w = w.to(torch.float32).contiguous()
    nf, nw = meta[1].shape[1:] if meta is not None else (0, 0)
    if nf > _MAX_FEATURES:
        raise ValueError(f"{name}: the step kernel takes at most {_MAX_FEATURES} metadata "
                         f"features, got {nf}")
    scratch = torch.empty((_scratch_floats(meta is not None, b, nf, nw),), dtype=torch.float32,
                          device=dev)
    if loss_out is None:
        loss = torch.empty((), dtype=torch.float32, device=dev)
        out_ptr = loss.data_ptr()
    else:
        loss = loss_out[loss_index]
        out_ptr = loss_out.data_ptr() + 4 * loss_index
    # launch on the tables' card (a device switch only when it is not current)
    switch = dev.index is not None and dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        rc = _lib().trs_fused_pairwise_step(*_step_args(
            user_pk, item_pk, ids, w, inv, lr, d, margin, loss_kind, sigmoid, eps, bf16, meta,
            scratch.data_ptr(), out_ptr, torch.cuda.current_stream(dev).cuda_stream,
        ))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    return loss


def fused_pairwise_step(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float = 1e-10,
    bf16: bool = False,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused training step on packed tables (:367-412). Updates
    ``user_pk`` and ``item_pk`` in place and returns them with the
    weighted mean loss (a device scalar), which also goes to
    ``loss_out[loss_index]`` when ``loss_out`` (a (n,) f32 tensor) is given.

    CUDA tables launch the step kernel (``fused_pairwise_step_kernel`` +
    ``fused_pairwise_apply_kernel``: rows read by id, update rows added in
    place, the loss stored); ``fused_pairwise_step.launches`` counts those
    calls. CPU tables take :func:`fused_pairwise_step_plain`; a check on
    the card calls that plain step directly."""
    ids = (user_ids, pos_ids, neg_ids)
    _check_step("fused_pairwise_step", d, loss_kind, user_pk, item_pk, ids, weights, loss_out,
                loss_index)
    if user_pk.device.type == "cpu":
        return fused_pairwise_step_plain(
            user_pk, item_pk, *ids, weights, lr, d=d, margin=margin, loss_kind=loss_kind,
            sigmoid=sigmoid, eps=eps, bf16=bf16, weight_sum=weight_sum, loss_out=loss_out,
            loss_index=loss_index,
        )
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    loss = _launch_step("fused_pairwise_step", user_pk, item_pk, ids, weights, inv, lr, d, margin,
                        loss_kind, sigmoid, eps, bf16, loss_out, loss_index)
    fused_pairwise_step.launches += 1
    fused_pairwise_step.variant = step_variant(loss_kind, sigmoid, weights is not None, bf16, False)
    return user_pk, item_pk, loss


fused_pairwise_step.launches = 0
fused_pairwise_step.variant = None


def fused_pairwise_step_meta(
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool = False,
    eps: float = 1e-10,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
    meta_lin: Optional[Sequence[torch.Tensor]] = None,
    fm: bool = False,
):
    """Single-device fused step for metadata-bearing Linear and FM
    (:811-864). ``meta_vec``: one augmented (Rf, D+1) table per feature;
    ``meta_ids`` / ``meta_mask``: (N_items, F, W) int64 / bool; FM
    (``fm=True``) also takes ``meta_lin``, one augmented (Rf, 2)
    linear-metadata table per feature. Updates every table in place;
    returns ``(user_pk, item_pk, meta_vec, loss)``, the loss also in
    ``loss_out[loss_index]`` when given. CPU tables take
    :func:`fused_pairwise_step_meta_plain`. On CUDA tables Linear launches
    the step kernel's metadata variant (``fused_pairwise_step_meta.launches``
    counts those calls); FM runs the row-level kernel once
    (``pairwise_updates_rows.launches``) between its torch gathers and
    scatters, and never the step kernel, whose metadata deltas are Linear's
    ``g u``."""
    ids = (user_ids, pos_ids, neg_ids)
    meta = (meta_vec, meta_ids, meta_mask)
    if fm != (meta_lin is not None):
        raise ValueError("fused_pairwise_step_meta: meta_lin goes with fm=True, and only with it")
    _check_step("fused_pairwise_step_meta", d, loss_kind, user_pk, item_pk, ids, weights,
                loss_out, loss_index, meta, meta_lin)
    if user_pk.device.type == "cpu":
        return fused_pairwise_step_meta_plain(
            user_pk, item_pk, meta_vec, meta_ids, meta_mask, *ids, weights, lr, d=d,
            margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, bf16=bf16, eps=eps,
            weight_sum=weight_sum, loss_out=loss_out, loss_index=loss_index, meta_lin=meta_lin, fm=fm,
        )
    if fm:
        return _fm_meta_step(
            pairwise_updates_rows, user_pk, item_pk, meta_vec, meta_lin, meta_ids, meta_mask, *ids,
            weights, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, bf16=bf16, eps=eps,
            weight_sum=weight_sum, loss_out=loss_out, loss_index=loss_index,
        )
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    loss = _launch_step("fused_pairwise_step_meta", user_pk, item_pk, ids, weights, inv, lr, d,
                        margin, loss_kind, sigmoid, eps, bf16, loss_out, loss_index, meta)
    fused_pairwise_step_meta.launches += 1
    fused_pairwise_step_meta.variant = step_variant(loss_kind, sigmoid, weights is not None, bf16, True)
    return user_pk, item_pk, meta_vec, loss


fused_pairwise_step_meta.launches = 0
fused_pairwise_step_meta.variant = None


# ---------------------------------------------------------------------------
# mesh wrappers (:415-641, :867-1034)
# ---------------------------------------------------------------------------


def _mesh_inv(mesh, b: int, weights: Optional[torch.Tensor], weight_sum: Optional[float]) -> float:
    """The loss normalizer of the global batch: ``1/(b n_data)`` without
    weights, else ``1 / max(global weight sum, 1)`` (``weight_sum``, the
    global sum when the caller knows it, saves a collective and a sync)."""
    if weights is None:
        return _inv_of(b * mesh.shape["data"], None)
    if weight_sum is None:
        weight_sum = float(all_reduce_(weights.to(torch.float32).sum().reshape(1), mesh.data))
    return _inv_of(b, weight_sum)


def _mesh_gather(mesh, tp: bool) -> Callable:
    if tp:
        return lambda t, ids: sharded_lookup(t, ids, mesh, "model")
    return _take


def _mesh_scatter(mesh, tp: bool) -> Callable:
    if tp:
        return lambda t, ids, rows: sharded_scatter_add(t, ids, rows, mesh, "model")
    return scatter_add_rows


def _mesh_step(mesh, tp, user_pk, item_pk, user_ids, pos_ids, neg_ids, weights, lr, *, d, margin, loss_kind,
               sigmoid, eps, bf16, weight_sum, loss_out, loss_index):
    _check_step("fused_pairwise_step_" + ("tp" if tp else "dp"), d, loss_kind, user_pk, item_pk,
                (user_ids, pos_ids, neg_ids), weights, loss_out, loss_index)
    b = user_ids.shape[0]
    inv = _mesh_inv(mesh, b, weights, weight_sum)
    gather = _mesh_gather(mesh, tp)
    iids = torch.cat([pos_ids, neg_ids])
    u, pn = gather(user_pk, user_ids), gather(item_pk, iids)
    upd_u, upd_items, loss_sum = pairwise_updates_rows(
        u, pn[:b], pn[b:], weights, inv, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid,
        eps=eps, bf16=bf16,
    )
    g_uids, g_iids, g_u, g_items = all_gather_many([user_ids, iids, upd_u, upd_items], mesh, "data")
    scatter = _mesh_scatter(mesh, tp)
    scatter(user_pk, g_uids, g_u)
    scatter(item_pk, g_iids, g_items)
    return user_pk, item_pk, _put_loss(loss_sum * inv, loss_out, loss_index)


def fused_pairwise_step_dp(
    mesh,
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float = 1e-10,
    bf16: bool = False,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Data-parallel fused step, B1 (:415-494): whole packed tables on every
    rank, ``user_ids``/``pos_ids``/``neg_ids``/``weights`` this rank's
    ``data`` shard of the batch (``weight_sum`` the global weight sum, if
    known). One launch of the row-level kernel on the shard's rows, the
    update rows and ids all-gathered over ``data``, the whole batch's
    updates scattered into every replica in the same fixed order (the
    tables stay bitwise replicated; duplicates across the global batch see
    the same accumulators, as on one device). Returns the tables (updated
    in place) and this rank's share of the step's loss
    (``loss_out[loss_index]`` too); the step's loss is the sum of the shares
    over ``data``, which the caller takes (the trainer once per epoch)."""
    return _mesh_step(mesh, False, user_pk, item_pk, user_ids, pos_ids, neg_ids, weights, lr, d=d,
                      margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps, bf16=bf16,
                      weight_sum=weight_sum, loss_out=loss_out, loss_index=loss_index)


def fused_pairwise_step_tp(
    mesh,
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    eps: float = 1e-10,
    bf16: bool = False,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused step on packed tables row-sharded over ``model``, B2
    (:497-641): the rows of the shard's ids rebuilt by masked local gather
    + psum over ``model`` (exact), one launch of the row-level kernel, the
    update rows and ids all-gathered over ``data``, and each rank adding
    the updates that land in its rows. Arguments as in
    :func:`fused_pairwise_step_dp`, with ``user_pk``/``item_pk`` this
    rank's row shards."""
    return _mesh_step(mesh, True, user_pk, item_pk, user_ids, pos_ids, neg_ids, weights, lr, d=d,
                      margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps, bf16=bf16,
                      weight_sum=weight_sum, loss_out=loss_out, loss_index=loss_index)


def _mesh_meta_step(mesh, tp, user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids, neg_ids,
                    weights, lr, *, d, margin, loss_kind, sigmoid, bf16, eps, weight_sum, loss_out, loss_index,
                    meta_lin, fm):
    name = "fused_pairwise_step_meta_" + ("tp" if tp else "dp")
    if fm != (meta_lin is not None):
        raise ValueError(f"{name}: meta_lin goes with fm=True, and only with it")
    _check_step(name, d, loss_kind, user_pk, item_pk, (user_ids, pos_ids, neg_ids), weights, loss_out,
                loss_index, (meta_vec, meta_ids, meta_mask), meta_lin)
    inv = _mesh_inv(mesh, user_ids.shape[0], weights, weight_sum)
    gather = _mesh_gather(mesh, tp)
    kw = dict(d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, bf16=bf16, eps=eps, gather=gather)
    if fm:
        upd_u, iids, item_rows, meta_deltas, lin_deltas, loss_sum = _fm_meta_step_core(
            pairwise_updates_rows, user_pk, item_pk, meta_vec, meta_lin, meta_ids, meta_mask, user_ids,
            pos_ids, neg_ids, weights, inv, lr, **kw,
        )
    else:
        upd_u, iids, item_rows, meta_deltas, loss_sum = _meta_step_core(
            user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids, neg_ids, weights, inv, lr,
            rows_fn=pairwise_updates_rows, **kw,
        )
        lin_deltas = []
    tables = [user_pk, item_pk, *meta_vec, *(meta_lin or ())]
    pairs = [(user_ids, upd_u), (iids, item_rows), *meta_deltas, *lin_deltas]
    got = all_gather_many([t for pair in pairs for t in pair], mesh, "data")
    scatter = _mesh_scatter(mesh, tp)
    for j, table in enumerate(tables):
        scatter(table, got[2 * j], got[2 * j + 1])
    return user_pk, item_pk, meta_vec, _put_loss(loss_sum * inv, loss_out, loss_index)


def fused_pairwise_step_meta_dp(
    mesh,
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool = False,
    eps: float = 1e-10,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
    meta_lin: Optional[Sequence[torch.Tensor]] = None,
    fm: bool = False,
):
    """Data-parallel metadata step, B3 (:867-938), Linear and FM
    (``fm=True`` with ``meta_lin``): the composite-row step of
    :func:`_meta_step_core` / :func:`_fm_meta_step_core` on this rank's
    shard with the row-level kernel (one launch), every update row (user,
    item, per-feature metadata and linear-metadata deltas) all-gathered
    over ``data`` and scattered into every replica in the same fixed order.
    Returns ``(user_pk, item_pk, meta_vec, loss)``, all tables updated in
    place, ``loss`` this rank's share as in :func:`fused_pairwise_step_dp`."""
    return _mesh_meta_step(mesh, False, user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids,
                           neg_ids, weights, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid,
                           bf16=bf16, eps=eps, weight_sum=weight_sum, loss_out=loss_out,
                           loss_index=loss_index, meta_lin=meta_lin, fm=fm)


def fused_pairwise_step_meta_tp(
    mesh,
    user_pk: torch.Tensor,
    item_pk: torch.Tensor,
    meta_vec: Sequence[torch.Tensor],
    meta_ids: torch.Tensor,
    meta_mask: torch.Tensor,
    user_ids: torch.Tensor,
    pos_ids: torch.Tensor,
    neg_ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    lr: float = 1e-2,
    *,
    d: int,
    margin: float,
    loss_kind: str,
    sigmoid: bool,
    bf16: bool = False,
    eps: float = 1e-10,
    weight_sum: Optional[float] = None,
    loss_out: Optional[torch.Tensor] = None,
    loss_index: int = 0,
    meta_lin: Optional[Sequence[torch.Tensor]] = None,
    fm: bool = False,
):
    """Metadata step with every table (packed user/item, metadata, linear
    metadata) row-sharded over ``model``, B4 (:941-1034): every gather a
    sharded lookup, every scatter masked to the rank's rows; the (N_items,
    F, W) feature ids and masks replicated. Arguments as in
    :func:`fused_pairwise_step_meta_dp`."""
    return _mesh_meta_step(mesh, True, user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids,
                           neg_ids, weights, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid,
                           bf16=bf16, eps=eps, weight_sum=weight_sum, loss_out=loss_out,
                           loss_index=loss_index, meta_lin=meta_lin, fm=fm)


# ---------------------------------------------------------------------------
# applicability (:1041-1085)
# ---------------------------------------------------------------------------


def pairwise_kernel_applicable(model, cfg, mesh=None) -> bool:
    """True when the whole train step runs as the fused kernel: a model
    with a packed pairwise layout (metadata needs two free g lanes, so
    ``n_factors <= 122`` there, else ``<= 124``), rowwise adagrad on the
    augmented layout, a one-negative supported loss, f32 params and f32 or
    bf16 compute. On a mesh whose ``model`` axis splits the tables, every
    table's padded rows must split evenly over it (:1058-1066)."""
    if getattr(model, "pairwise_pack", None) is None:
        return False
    if mesh is not None:
        from torchrecsys_tpu_torch.models.base import padded_rows

        m = mesh.shape.get("model", 1)
        if m > 1 and any(padded_rows(spec.rows) % m for spec in model.table_specs().values()):
            return False
    d = model.cfg.n_factors
    if model.schema.metadata_names and not (model.pairwise_meta and d <= LANES - 6):
        return False
    return (
        cfg.embedding_optimizer == "rowwise_adagrad"
        and cfg.fused_embedding_update
        and cfg.loss in SUPPORTED_LOSSES
        and cfg.num_negatives == 1
        and model.param_dtype == torch.float32
        and model.compute_dtype in (torch.float32, torch.bfloat16)
        and d <= LANES - 4
    )

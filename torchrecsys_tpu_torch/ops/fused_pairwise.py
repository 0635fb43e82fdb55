"""The fused pairwise train step of the factorization models: a
hand-written Hopper kernel and its plain version.

Port of ``torchrecsys_tpu/ops/fused_pairwise.py`` (single device, Linear).
Per batch:

    gather packed rows -> [kernel: score pos|neg -> loss -> row grads ->
    rowwise-adagrad deltas] -> index_add_ the update rows

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

- :func:`pairwise_updates_rows` launches ``fused_pairwise_kernel``
  (``csrc/fused_pairwise.cu``), the port of ``_pairwise_kernel``
  (:100-243) as ``_pairwise_updates_rows`` (:279-357) calls it. Given CPU
  tensors it computes :func:`pairwise_updates_rows_plain`; given CUDA
  tensors it launches the kernel or raises. ``pairwise_updates_rows.launches``
  counts launches.
- :func:`fused_pairwise_step` (:367-412) and
  :func:`fused_pairwise_step_meta` (:811-864, Linear) update the packed
  tables IN PLACE (``index_add_``) and return them with the step's loss as
  a device scalar. The scalars ``inv``, ``lr``, ``margin`` and ``eps`` are
  launch arguments, so the caller passes host values and no step syncs.
- The FM branches (``fm=True``: ``_packed_update_rows``, ``meta_lin``)
  and the mesh wrappers (``_dp``, ``_tp``) are still to be ported
  (ROADMAP.md §A items 5 and 14).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.ops import _build

LANES = 128
SUPPORTED_LOSSES = ("hinge", "bpr", "logistic")
_LOSS_CODE = {"hinge": 0, "bpr": 1, "logistic": 2}
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
    return uo, items, loss_sum


pairwise_updates_rows.launches = 0

UpdatesFn = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def step_inv(b: int, weights: Optional[torch.Tensor], weight_sum: Optional[float] = None) -> float:
    """The loss normalizer as an f32 value on the host: ``1/b`` without
    weights, else ``1 / max(sum(w), 1)``. ``weight_sum`` saves the device
    sum (a sync) when the caller knows it, as the trainer does."""
    if weights is None:
        return float(np.float32(1.0 / b))
    if weight_sum is None:
        weight_sum = float(weights.to(torch.float32).sum())
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
    updates_fn: Optional[UpdatesFn] = None,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Gather packed rows (one gather for the user rows, one for the
    positive then negative item rows) and run the row math. Returns
    ``(iids (2B,), upd_u, upd_items, loss_sum)``."""
    b = user_ids.shape[0]
    iids = torch.cat([pos_ids, neg_ids])
    u = user_pk.index_select(0, user_ids)
    pn = item_pk.index_select(0, iids)
    fn = updates_fn or pairwise_updates_rows
    upd_u, upd_items, loss_sum = fn(u, pn[:b], pn[b:], weights, inv, lr, **kw)
    return iids, upd_u, upd_items, loss_sum


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
    updates_fn: Optional[UpdatesFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused training step on packed tables (:367-412): gather -> row
    math -> two ``index_add_`` scatters (user rows; item rows, positives
    then negatives). Updates ``user_pk`` and ``item_pk`` in place and
    returns them with the weighted mean loss (a device scalar).

    ``updates_fn`` replaces the row math (default
    :func:`pairwise_updates_rows`); a check on the card passes
    :func:`pairwise_updates_rows_plain` to hold the kernel's steps
    against it."""
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    iids, upd_u, upd_items, loss_sum = _pairwise_updates(
        user_pk, item_pk, user_ids, pos_ids, neg_ids, weights, inv, lr, updates_fn,
        d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid, eps=eps, bf16=bf16,
    )
    user_pk.index_add_(0, user_ids, upd_u)
    item_pk.index_add_(0, iids, upd_items)
    return user_pk, item_pk, loss_sum * inv


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
    updates_fn: Optional[UpdatesFn] = None,
):
    """Composite-row kernel step + the metadata updates, Linear (:660-801
    with ``fm=False``).

    The item rows the kernel sees are composite: their vector lanes hold
    ``item_vec + sum_f masked_sum(meta_f)``, so the score, the loss and the
    user update are the model's. For Linear d score / d item_vec = d score
    / d meta slot = g * u, so the kernel's item update rows (formed against
    the item's own accumulator lanes, which composition leaves alone) are
    exact, and each metadata slot's rowwise-adagrad delta is formed here
    from the ``gp``/``gn`` the kernel emits in lanes d+4, d+5.

    Returns ``(upd_u (B, 128), iids (2B,), item_rows (2B, 128),
    meta_deltas [F x (ids (2BW,), rows (2BW, D+1))], loss_sum)``."""
    b = user_ids.shape[0]
    f32 = torch.float32
    iids = torch.cat([pos_ids, neg_ids])
    u = user_pk.index_select(0, user_ids)
    pn = item_pk.index_select(0, iids)  # (2B, 128), composited in place below
    mids = meta_ids.index_select(0, iids)  # (2B, F, W)
    mm = meta_mask.index_select(0, iids).to(f32)
    rows = []
    csum = None
    for f in range(len(meta_vec)):
        r = meta_vec[f][mids[:, f, :]]  # (2B, W, D+1)
        rows.append(r)
        c = torch.sum(r[..., :d] * mm[:, f, :, None], dim=1)  # masked_sum
        csum = c if csum is None else csum + c
    if csum is not None:
        pn[:, :d] += csum

    fn = updates_fn or pairwise_updates_rows
    upd_u, item_rows, loss_sum = fn(
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
    updates_fn: Optional[UpdatesFn] = None,
):
    """Single-device fused step for metadata-bearing Linear (:811-864 with
    ``fm=False``; the FM branch is ROADMAP.md §A item 5). ``meta_vec``: one
    augmented (Rf, D+1) table per feature. Updates every table in place;
    returns ``(user_pk, item_pk, meta_vec, loss)``."""
    inv = step_inv(user_ids.shape[0], weights, weight_sum)
    upd_u, iids, item_rows, meta_deltas, loss_sum = _meta_step_core(
        user_pk, item_pk, meta_vec, meta_ids, meta_mask, user_ids, pos_ids, neg_ids,
        weights, inv, lr, d=d, margin=margin, loss_kind=loss_kind, sigmoid=sigmoid,
        bf16=bf16, eps=eps, updates_fn=updates_fn,
    )
    user_pk.index_add_(0, user_ids, upd_u)
    item_pk.index_add_(0, iids, item_rows)
    for table, (ids, delta) in zip(meta_vec, meta_deltas):
        table.index_add_(0, ids, delta)
    return user_pk, item_pk, meta_vec, loss_sum * inv


# ---------------------------------------------------------------------------
# applicability (:1041-1085, no mesh)
# ---------------------------------------------------------------------------


def pairwise_kernel_applicable(model, cfg) -> bool:
    """True when the whole train step runs as the fused kernel: a model
    with a packed pairwise layout (metadata needs two free g lanes, so
    ``n_factors <= 122`` there, else ``<= 124``), rowwise adagrad on the
    augmented layout, a one-negative supported loss, f32 params and f32 or
    bf16 compute."""
    if getattr(model, "pairwise_pack", None) is None:
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

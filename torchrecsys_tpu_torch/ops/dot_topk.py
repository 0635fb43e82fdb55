"""Fused full-catalog score + top-k: a hand-written Hopper kernel.

Port of ``torchrecsys_tpu/ops/dot_topk.py``. For every user u it returns
the k best items of ``user_vecs[u] . item_vecs[g] + item_bias[g]``,
descending, ties broken by the lowest item index (``jax.lax.top_k``'s rule,
ops/dot_topk.py:98-133), with f32 accumulation from f32 or bf16 vectors.

- :func:`dot_topk_small` (k <= 16) is the port of ``_dot_topk_kernel``
  (ops/dot_topk.py:136-198): ``dot_topk_tc_kernel`` keeping 16 entries per
  (user, catalog split).
- :func:`dot_topk_large` (16 < k <= 1024) is the port of
  ``_dot_topk_threshold_kernel`` (ops/dot_topk.py:362-441): the same kernel
  keeping k entries. Its result is fully sorted and exact under ties at
  the k-th value, which the TPU kernel documents as loose.
- :func:`dot_topk_plain` is both kernels' plain version: a matmul and a
  stable descending sort, chunked over items so the (U, N) score matrix
  never exists at once. Above k = 1024 it is also the path itself, as XLA
  is in the JAX package (ops/dot_topk.py:631).

The kernel (scores on the tensor cores, 3xTF32 for f32; threshold-gated
selection) and its split merge live in ``csrc/dot_topk.cu``, built on first
use by ``ops/_build.py``. A wrapper given CPU tensors computes the plain
version; given CUDA tensors it launches the kernels or raises -- there is
no fallback. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.ops import _build
from torchrecsys_tpu_torch.utils.profiling import count

_NEG_INF = float(np.finfo(np.float32).min)  # ops/dot_topk.py:36

# Dispatch limits of ops/dot_topk.py:350-351.
_PALLAS_UNROLLED_MAX_K = 16
_PALLAS_THRESH_MAX_K = 1024

# Widest row the kernel takes as one ring unit; wider rows take the slab
# path, whose item tiles arrive as TMA boxes (csrc/dot_topk.cu, kSlab).
_SLAB_WIDTH = 128

# Items per step of the plain version's running merge (a 256-user step
# holds a 64 MB score block).
_PLAIN_CHUNK = 65536


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Packed per-user seen masks (ops/dot_topk.py:47-87): within each
# _MASK_TILE-item tile, item j lives in word (j % W), bit (j // W), with
# W = _MASK_TILE / 32. The layout is kept bit for bit so masks are
# interchangeable with the JAX package's.
# ---------------------------------------------------------------------------

_MASK_TILE = 4096


def pack_seen_mask(seen_lists: Sequence[Sequence[int]], n: int) -> np.ndarray:
    """Per-user seen item-row lists -> (U, n_pad/32) int32 packed mask, with
    n_pad = n rounded up to _MASK_TILE (ops/dot_topk.py:62-76)."""
    w = _MASK_TILE // 32
    n_pad = _round_up(max(n, 1), _MASK_TILE)
    out = np.zeros((len(seen_lists), n_pad // 32), np.uint32)
    lens = [len(s) for s in seen_lists]
    if sum(lens):
        uu = np.repeat(np.arange(len(seen_lists)), lens)
        gg = np.concatenate([np.asarray(s, np.int64) for s in seen_lists])
        j = gg % _MASK_TILE
        word = (gg // _MASK_TILE) * w + (j % w)
        bit = (j // w).astype(np.uint32)
        np.bitwise_or.at(out, (uu, word), np.uint32(1) << bit)
    return out.view(np.int32)


def pack_seen_mask_torch(
    user_pos: torch.Tensor, item_rows: torch.Tensor, num_users: int, n: int
) -> torch.Tensor:
    """:func:`pack_seen_mask` built where the tensors lie: user ``user_pos[i]``
    has seen item ``item_rows[i]``. The (user, item) pairs must be distinct:
    each bit is then added at most once per word, so the sum is the OR."""
    w = _MASK_TILE // 32
    words = _round_up(max(n, 1), _MASK_TILE) // 32
    j = item_rows % _MASK_TILE
    word = (item_rows // _MASK_TILE) * w + (j % w)
    bit = (j // w).to(torch.int32)
    one = torch.ones_like(bit)
    vals = torch.where(bit == 31, torch.iinfo(torch.int32).min, one << bit.clamp(max=30))
    out = torch.zeros(num_users * words, dtype=torch.int32, device=item_rows.device)
    out.index_add_(0, user_pos * words + word, vals)
    return out.view(num_users, words)


def mask_bits_for_items(mask: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    """(U, n_pad/32) packed mask x (C,) item rows -> (U, C) bool
    (ops/dot_topk.py:79-87)."""
    w = _MASK_TILE // 32
    j = item_ids % _MASK_TILE
    word = (item_ids // _MASK_TILE) * w + (j % w)
    bit = (j // w).to(mask.dtype)
    words = mask.index_select(1, word)
    return ((words >> bit[None, :]) & 1) != 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _vector_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The score dtype rule of ops/dot_topk.py:231-233: bf16 stays bf16,
    anything else computes in f32."""
    vdt = torch.promote_types(a.dtype, b.dtype)
    return vdt if vdt in (torch.float32, torch.bfloat16) else torch.float32


@contextlib.contextmanager
def _ieee_f32_matmul(device: torch.device):
    """Full-f32 matmuls on the card (no TF32), so the plain version stays a
    yardstick."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dot_topk_plain(
    user_vecs: torch.Tensor,  # (U, D)
    item_vecs: torch.Tensor,  # (N, D)
    item_bias: torch.Tensor,  # (N,)
    k: int,
    seen_mask: Optional[torch.Tensor] = None,  # (U, n_pad/32) pack_seen_mask
    chunk: int = _PLAIN_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch top-k of ``user_vecs @ item_vecs.T + item_bias``: (U, k)
    f32 scores and int32 item rows, descending, lowest index first among
    ties (the reference ``dot_topk_xla``, ops/dot_topk.py:309-334).

    bf16 vectors are widened to f32 before the matmul, so every product is
    exact and sums run in f32. Items are scored ``chunk`` at a time; a
    stable descending sort of [running top-k, chunk] keeps the earlier
    (lower) index first among equal scores."""
    n = item_vecs.shape[0]
    u = user_vecs.shape[0]
    k = min(k, n)
    dev = user_vecs.device
    vdt = _vector_dtype(user_vecs, item_vecs)
    uv = user_vecs.to(vdt).float()
    top_v = torch.empty((u, 0), dtype=torch.float32, device=dev)
    top_i = torch.empty((u, 0), dtype=torch.int64, device=dev)
    with _ieee_f32_matmul(dev):
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            ids = torch.arange(s, e, device=dev)
            sc = uv @ item_vecs[s:e].to(vdt).float().T
            sc = sc + item_bias[s:e].float()[None, :]
            if seen_mask is not None:
                sc = torch.where(mask_bits_for_items(seen_mask, ids), _NEG_INF, sc)
            cat_v = torch.cat([top_v, sc], dim=1)
            cat_i = torch.cat([top_i, ids[None, :].expand(u, -1)], dim=1)
            v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
            top_v = v[:, :k]
            top_i = torch.gather(cat_i, 1, pos[:, :k])
    return top_v, top_i.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("dot_topk.cu")
    if not getattr(lib, "_trs_bound", False):
        lib.trs_dot_topk_plan.argtypes = [_CI] * 6 + [ctypes.POINTER(_CI)] * 8
        lib.trs_dot_topk_plan.restype = _CI
        lib.trs_dot_topk_tensor_map.argtypes = [_VP] + [_CI] * 3 + [_VP]
        lib.trs_dot_topk_tensor_map.restype = _CI
        lib.trs_dot_topk.argtypes = [_CI] + [_VP] * 4 + [_CI] * 7 + [_VP] * 7
        lib.trs_dot_topk.restype = _CI
        lib._trs_bound = True
    return lib


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _device_index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as an int for a C launch: torch's
    raw accessor where the build has one (the public one builds a Stream
    object, several microseconds a call)."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(dev).cuda_stream
    return _RAW_STREAM(_device_index(dev))


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


_PLANS: dict = {}


class Plan(NamedTuple):
    """The kernel's launch plan for one shape (``trs_dot_topk_plan``)."""

    splits: int  # catalog splits, one wave of (user tile x split) blocks
    list_len: int  # entries kept per (user, split)
    cap: int  # candidate buffer entries per user
    smem: int  # dynamic shared memory bytes per block
    stages: int  # item ring slots
    keys: int  # threshold keys per user that the lists publish to each other
    user_tile: int  # users per block
    slot_bytes: int  # bytes of a ring slot: a tile of D <= 128, else a 16 KB unit of two boxes


def plan(large: bool, u: int, n: int, d: int, bf16: bool, k: int) -> Plan:
    """The kernel's launch plan on the current device, made once per shape
    and device: the C call also opts the kernels into their shared memory
    and queries occupancy. ``d`` is the row width the kernel sees (a
    multiple of 4 for f32, of 8 for bf16); above 128 the kernel scores it
    in two-box units of 128-byte TMA boxes with every unit's user images
    resident, so a width at which not even an 8-user tile fits shared
    memory raises."""
    key = (bool(large), u, n, d, bool(bf16), k, _device_index(torch.device("cuda")))
    got = _PLANS.get(key)
    if got is None:
        count("dot_topk.plans")
        out = [_CI() for _ in Plan._fields]
        rc = _lib().trs_dot_topk_plan(int(large), u, n, d, int(bf16), k, *map(ctypes.byref, out))
        if rc != 0:
            raise ValueError(
                f"dot_topk plan: no kernel variant takes U={u}, N={n}, D={d}, "
                f"{'bf16' if bf16 else 'f32'}, k={k} (cudaError {rc})"
            )
        got = _PLANS[key] = Plan(*(v.value for v in out))
    return got


# The slab path's TMA maps (128 bytes each) by (table address, N, D, bf16,
# device): a map holds only the table's address and shape, so a table at a
# reused address takes the same map.
_TENSOR_MAPS: dict = {}
_MAX_TENSOR_MAPS = 64


def _tensor_map(items: torch.Tensor, n: int, d: int, bf16: bool):
    key = (items.data_ptr(), n, d, bool(bf16), _device_index(items.device))
    got = _TENSOR_MAPS.get(key)
    if got is None:
        count("dot_topk.tensor_maps")
        if len(_TENSOR_MAPS) >= _MAX_TENSOR_MAPS:
            _TENSOR_MAPS.clear()
        got = ctypes.create_string_buffer(128)
        rc = _lib().trs_dot_topk_tensor_map(items.data_ptr(), n, d, int(bf16), got)
        if rc != 0:
            raise RuntimeError(f"dot_topk: the TMA map of the ({n}, {d}) item table failed (CUresult {rc})")
        _TENSOR_MAPS[key] = got
    return got


def _rows16(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (rows, D) as rows of ``width`` >= D values (zero-padded) at a
    16-byte aligned base: the kernel bulk-copies whole 16-byte item rows."""
    if x.shape[1] != width:
        return torch.nn.functional.pad(x, (0, width - x.shape[1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(name, user_vecs, item_vecs, item_bias, k, seen_mask, large):
    """Validate CUDA inputs and launch the score + selection kernel, then
    the split merge (``large`` picks #2's list of k over #1's 16). Returns
    (U, k) f32 scores and int32 item rows."""
    dev = user_vecs.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, got {dev}")
    for t in (item_vecs, item_bias) + ((seen_mask,) if seen_mask is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices ({t.device} vs {dev})")
    if user_vecs.dim() != 2 or item_vecs.dim() != 2 or item_bias.dim() != 1:
        raise ValueError(f"{name}: expected users (U, D), items (N, D), bias (N,)")
    u, d = user_vecs.shape
    n = item_vecs.shape[0]
    if item_vecs.shape[1] != d or item_bias.shape[0] != n:
        raise ValueError(
            f"{name}: shapes {tuple(user_vecs.shape)}, {tuple(item_vecs.shape)}, "
            f"{tuple(item_bias.shape)} do not agree"
        )
    if u < 1 or n < 1 or k < 1:
        raise ValueError(f"{name}: empty input (U={u}, N={n}, k={k})")
    lib = _lib()
    vdt = _vector_dtype(user_vecs, item_vecs)
    bf16 = vdt == torch.bfloat16
    width = _round_up(d, 8 if bf16 else 4)
    uv = _rows16(user_vecs.to(vdt).contiguous(), width)
    iv = _rows16(item_vecs.to(vdt).contiguous(), width)
    ib = item_bias.to(torch.float32).contiguous()
    mask, mw = None, 0
    if seen_mask is not None:
        mw = _round_up(n, _MASK_TILE) // 32
        if tuple(seen_mask.shape) != (u, mw) or seen_mask.dtype != torch.int32:
            raise ValueError(
                f"seen_mask {tuple(seen_mask.shape)} {seen_mask.dtype} != "
                f"({u}, {mw}) int32 -- build it with pack_seen_mask(seen_lists, n={n})"
            )
        mask = seen_mask.contiguous()
    with torch.cuda.device(dev):
        p = plan(large, u, n, width, bf16, k)
        s, list_len, keys = p.splits, p.list_len, p.keys
        tmap = _tensor_map(iv, n, width, bf16) if width > _SLAB_WIDTH else None
        # scratch: the (user, split) lists' values and rows, then the
        # 8-byte keys they publish
        npart = u * s * list_len
        part = torch.empty(2 * npart + 2 * u * keys, dtype=torch.int32, device=dev)
        out = torch.empty(2 * u * k, dtype=torch.int32, device=dev)
        out_v = out[: u * k].view(torch.float32).view(u, k)
        out_i = out[u * k :].view(u, k)
        rc = lib.trs_dot_topk(
            int(large), uv.data_ptr(), iv.data_ptr(), ib.data_ptr(),
            mask.data_ptr() if mask is not None else None, mw,
            u, n, width, int(bf16), k, s,
            part.data_ptr(), part.data_ptr() + 4 * npart, part.data_ptr() + 8 * npart,
            out_v.data_ptr(), out_i.data_ptr(), tmap,
            _stream(dev),
        )
    _check(rc, name)
    return out_v, out_i


def dot_topk_small(
    user_vecs: torch.Tensor,
    item_vecs: torch.Tensor,
    item_bias: torch.Tensor,
    k: int,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (k <= 16) of ``user_vecs @ item_vecs.T + item_bias``: (U, k) f32
    scores and int32 item rows, descending, lowest index first among ties.

    CUDA tensors launch ``dot_topk_tc_kernel`` over (64-user tile x
    catalog split) blocks, one wave of them, keeping 16 entries per (user,
    split), then the split merge. CPU tensors take :func:`dot_topk_plain`."""
    if user_vecs.device.type == "cpu":
        return dot_topk_plain(user_vecs, item_vecs, item_bias, k, seen_mask)
    k = min(k, item_vecs.shape[0])
    if k > _PALLAS_UNROLLED_MAX_K:
        raise ValueError(f"dot_topk_small takes k <= {_PALLAS_UNROLLED_MAX_K}, got {k}")
    out = _launch("dot_topk_small", user_vecs, item_vecs, item_bias, k, seen_mask, False)
    dot_topk_small.launches += 1
    return out


dot_topk_small.launches = 0


def dot_topk_large(
    user_vecs: torch.Tensor,
    item_vecs: torch.Tensor,
    item_bias: torch.Tensor,
    k: int,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (any k <= 1024; the dispatch sends 16 < k <= 1024) with the
    contract of :func:`dot_topk_small`.

    CUDA tensors launch ``dot_topk_tc_kernel`` over (32-user tile, or
    8-user for k > 128, x catalog split) blocks keeping k entries per
    (user, split), then the split merge. CPU tensors take
    :func:`dot_topk_plain`."""
    if user_vecs.device.type == "cpu":
        return dot_topk_plain(user_vecs, item_vecs, item_bias, k, seen_mask)
    k = min(k, item_vecs.shape[0])
    if k > _PALLAS_THRESH_MAX_K:
        raise ValueError(f"dot_topk_large takes k <= {_PALLAS_THRESH_MAX_K}, got {k}")
    out = _launch("dot_topk_large", user_vecs, item_vecs, item_bias, k, seen_mask, True)
    dot_topk_large.launches += 1
    return out


dot_topk_large.launches = 0


def dot_topk(
    user_vecs: torch.Tensor,
    item_vecs: torch.Tensor,
    item_bias: torch.Tensor,
    k: int,
    approx_recall: Optional[float] = None,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score + top-k with the dispatch of ops/dot_topk.py:595-631:
    k <= 16 -> :func:`dot_topk_small`, k <= 1024 -> :func:`dot_topk_large`,
    larger k -> :func:`dot_topk_plain`.

    ``approx_recall`` is accepted and the result is exact: the JAX package's
    approximate path is the TPU's hardware top-k, which off the TPU
    degenerates to exact top-k (ops/dot_topk.py:557-558); the port does the
    same on every device."""
    del approx_recall
    k = min(k, item_vecs.shape[0])
    if k <= _PALLAS_UNROLLED_MAX_K:
        return dot_topk_small(user_vecs, item_vecs, item_bias, k, seen_mask)
    if k <= _PALLAS_THRESH_MAX_K:
        return dot_topk_large(user_vecs, item_vecs, item_bias, k, seen_mask)
    return dot_topk_plain(user_vecs, item_vecs, item_bias, k, seen_mask)

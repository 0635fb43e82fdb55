"""The ('data', 'model') mesh over the ranks of a ``torch.distributed``
world, and the collectives the port builds on it (port of
``torchrecsys_tpu/parallel/mesh.py``; the collectives are what
``jax.lax.all_gather`` / ``psum`` do inside the JAX package's
``shard_map`` bodies).

- ``data`` splits the batch (data parallelism); ``model`` splits the rows
  of the embedding tables. Rank ``r`` sits at ``(r // model, r % model)``,
  the order of JAX's ``np.reshape(devices, (data, model))``.
- :class:`Mesh` holds this rank's coordinates, its device and one process
  group per axis it belongs to: the ranks of its data row (collectives
  over ``model``) and of its model column (collectives over ``data``).
- Every collective is made of ``all_reduce`` alone, the one reduction
  gloo carries on CUDA tensors besides ``broadcast``: :func:`all_gather`
  all-reduces a zeroed ``(n, ...)`` buffer in which each rank has filled
  its own slot, which is exact (each slot has one non-zero term; only a
  ``-0.0`` comes back as ``+0.0``), the zeros-plus-``psum`` of JAX's own
  row-sharded gather. The slots take uneven lengths too: given every
  rank's row count, each slot is padded to the longest and the filler
  dropped. :func:`all_gather`, :func:`psum` and :func:`sum_shares` are
  ``torch.autograd.Function``\\ s: the backward of the tiled all-gather
  all-reduces the cotangent and takes this rank's slice; a ``psum`` whose
  result every rank then uses alike passes its cotangent through.
- :func:`sum_shares` adds per-rank shares of a sum (a rank's part of the
  dense gradients, of the batch-norm statistics over ``data``): every
  rank's share in its slot, then the slots added in rank order, so every
  rank holds the same bits and replicas of what is computed from the sum
  (the dense parameters, the running statistics) stay bitwise equal. Its
  backward does the same to the cotangent: with each rank holding its
  share of the loss, the cotangent of the global sum is the sum of the
  ranks' cotangents.
- :data:`stats` counts the collectives and, when ``stats.timing`` is on,
  their seconds between two device syncs (a measurement mode: the syncs
  cost time of their own).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass
class CollectiveStats:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timing: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


stats = CollectiveStats()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, and the process group of the ranks that differ only along it
    (None when it has one rank)."""

    size: int
    index: int
    group: Optional[object]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ('data', 'model') mesh."""

    data: Axis
    model: Axis
    device: torch.device
    rank: int
    world: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}

    @property
    def data_rank(self) -> int:
        return self.data.index

    @property
    def model_rank(self) -> int:
        return self.model.index

    def axis(self, name: str) -> Axis:
        if name not in AXES:
            raise ValueError(f"mesh axis must be one of {AXES}, got {name!r}")
        return self.data if name == "data" else self.model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data.size}, model={self.model.size}, rank={self.rank} at "
                f"({self.data.index}, {self.model.index}), device={self.device})")


def _split(n: int, data: Optional[int], model: Optional[int]):
    """The JAX package's axis inference (:27-54)."""
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    elif model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    if data * model != n:
        raise ValueError(f"data*model = {data}*{model} != {n} devices")
    return data, model


def rank_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK or rank) % cards`` for a CUDA
    request without an index (ranks share the cards round-robin), the CPU
    when asked. A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(dev)!r} was requested but torch finds no CUDA device; "
                "pass device='cpu' to run the mesh on the CPU"
            )
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(
    data: Optional[int] = None,
    model: Optional[int] = None,
    device: Union[str, torch.device, None] = "cuda",
) -> Mesh:
    """A ('data', 'model') mesh over every rank of the initialized world (a
    world of one without ``init_distributed``). Defaults as in JAX: ``data``
    = every rank, ``model`` = 1. Every rank must call it, with the same
    arguments: it creates the axes' process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, model = _split(world, data, model)
    di, mi = divmod(rank, model)
    groups = {}
    for name, size, members in (
        ("model", model, [[d * model + j for j in range(model)] for d in range(data)]),
        ("data", data, [[i * model + m for i in range(data)] for m in range(model)]),
    ):
        if size == 1:
            groups[name] = None
        elif size == world:
            groups[name] = dist.group.WORLD
        else:  # every rank creates every group, in the same order
            made = [dist.new_group(r) for r in members]
            groups[name] = made[di if name == "model" else mi]
    return Mesh(
        data=Axis(data, di, groups["data"]),
        model=Axis(model, mi, groups["model"]),
        device=rank_device(device),
        rank=rank,
        world=world,
    )


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``ax``, in place (a no-op on one rank)."""
    if ax.size == 1:
        return x
    stats.calls += 1
    stats.bytes += x.numel() * x.element_size()
    if not stats.timing:
        dist.all_reduce(x, group=ax.group)
        return x
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    dist.all_reduce(x, group=ax.group)
    if cuda:
        torch.cuda.synchronize(x.device)
    stats.seconds += time.perf_counter() - t0
    return x


def _slots(x: torch.Tensor, ax: Axis, length: Optional[int] = None) -> torch.Tensor:
    """(n, length, *x.shape[1:]): every rank's ``x`` in its slot (its first
    ``x.shape[0]`` rows; ``length`` defaults to them), by one all-reduce of
    zeros with this rank's slot filled."""
    length = x.shape[0] if length is None else length
    buf = torch.zeros((ax.size, length) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    buf[ax.index, : x.shape[0]] = x
    return all_reduce_(buf, ax)


def _unslot(slots: torch.Tensor, rows: Optional[Sequence[int]]) -> torch.Tensor:
    """The slots' rows in rank order, each slot cut to its rank's count."""
    if rows is None:
        return slots.reshape((-1,) + tuple(slots.shape[2:]))
    return torch.cat([slots[r, :n] for r, n in enumerate(rows)])


def _rank_sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every rank's ``x`` added in rank order: the same bits on every rank."""
    slots = _slots(x.reshape(1, -1), ax)[:, 0]
    out = slots[0]
    for r in range(1, ax.size):
        out = out + slots[r]
    return out.reshape(x.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, rows):
        ctx.ax, ctx.rows = ax, rows
        return _unslot(_slots(x, ax, None if rows is None else max(rows)), rows)

    @staticmethod
    def backward(ctx, g):
        ax, rows = ctx.ax, ctx.rows
        # the ranks' partial cotangents (a bf16 dv under AMP) summed in f32,
        # rounded to their dtype once, as one device's single sum is
        dt = g.dtype
        g = all_reduce_(g.to(torch.float32 if g.is_floating_point() else dt).contiguous().clone(), ax)
        if rows is None:
            g = g.reshape((ax.size, -1) + tuple(g.shape[1:]))[ax.index]
        else:
            start = sum(rows[: ax.index])
            g = g[start : start + rows[ax.index]]
        return g.to(dt), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce_(x.contiguous().clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _rank_sum(x.contiguous(), ax)

    @staticmethod
    def backward(ctx, g):
        return _rank_sum(g.contiguous(), ctx.ax), None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "data", rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)``: every rank's ``x``
    concatenated along dim 0 in rank order; ``rows`` gives every rank's
    row count where they differ. Differentiable: the backward all-reduces
    the cotangent and takes this rank's rows."""
    ax = mesh.axis(axis)
    return x if ax.size == 1 else _AllGather.apply(x, ax, None if rows is None else tuple(rows))


def sum_shares(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The sum over the ranks of ``axis`` of each rank's share ``x``, added
    in rank order (the same bits on every rank). Differentiable: the
    cotangent is summed the same way (each rank's loss is its share)."""
    ax = mesh.axis(axis)
    return x if ax.size == 1 else _SumShares.apply(x, ax)


def sum_shares_many(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """:func:`sum_shares` of several tensors (no gradient) in one
    collective per dtype."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        total = _rank_sum(torch.cat([tensors[i].reshape(-1) for i in idx]), ax)
        for i, part in zip(idx, torch.split(total, [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape)
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` of per-rank partials into a value every
    rank then uses alike; differentiable, its cotangent passed through."""
    ax = mesh.axis(axis)
    return x if ax.size == 1 else _PSum.apply(x, ax)


def all_gather_many(
    tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data", rows: Optional[Sequence[int]] = None
) -> List[torch.Tensor]:
    """:func:`all_gather` of several tensors (no gradient) in one
    collective per dtype: each rank's tensors flattened into one slot.
    ``rows``: every rank's count of the rows the tensors are laid out by,
    where they differ; each tensor's dim 0 is then a whole multiple of
    this rank's count, the same multiple on every rank."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return list(tensors)
    counts = [1] * ax.size if rows is None else list(rows)
    own = counts[ax.index]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        if rows is not None and t.shape[0] % own:
            raise ValueError(f"all_gather_many: dim 0 of {tuple(t.shape)} is not a multiple of {own} rows")
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        # rank r's slot: each tensor's numel scaled to r's rows, in order
        per = [tensors[i].numel() // own for i in idx]  # elements per row of each tensor
        length = max(sum(per) * c for c in counts)
        slots = _slots(torch.cat([tensors[i].reshape(-1) for i in idx]), ax, length)
        at = [0] * ax.size
        for i, k in zip(idx, per):
            t = tensors[i]
            parts = []
            for r, c in enumerate(counts):
                parts.append(slots[r, at[r] : at[r] + k * c])
                at[r] += k * c
            out[i] = torch.cat(parts).reshape((-1,) + tuple(t.shape[1:]))
    return out

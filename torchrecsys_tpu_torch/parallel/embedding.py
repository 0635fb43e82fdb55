"""Row-sharded embedding lookup and update (port of
``torchrecsys_tpu/parallel/embedding.py``).

A table is row-sharded over ``model``: model rank m holds rows ``[m R/M,
(m+1) R/M)`` of its R padded rows.

- :func:`sharded_lookup` (:38-61), "gather + psum": every rank masks the
  id batch (the same on every rank of its data row) to its row range,
  gathers locally with the rows outside it zeroed, and one ``psum`` over
  ``model`` rebuilds the full rows, exactly (one non-zero term per row).
  Its backward is the masked local scatter of the cotangent into the
  shard (``tests/test_sharding.py:149-160`` checks this gradient in JAX).
- :func:`sharded_scatter_add` (:64-96), the transpose: every rank adds
  the rows that land in its range, no collective at all.
- :func:`scatter_add_rows` is the scatter-add every replica of a table
  applies: on the card ``index_put_(accumulate=True)``, whose sort-based
  kernel adds the duplicates of an id in a fixed order, so replicas given
  the same updates stay bitwise equal (``index_add_``'s float atomics add
  them in no fixed order); on the CPU ``index_add_``, sequential.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchrecsys_tpu_torch.parallel.mesh import Mesh, psum


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[ids] += rows`` in place, duplicates added in a fixed order."""
    rows = rows.to(table.dtype)
    if table.device.type == "cuda":
        table.index_put_((ids,), rows, accumulate=True)
    else:
        table.index_add_(0, ids, rows)
    return table


def shard_range(table_shard: torch.Tensor, mesh: Mesh, axis: str = "model") -> Tuple[int, int]:
    """[start, stop) of the global rows this rank's shard holds."""
    rows = table_shard.shape[0]
    start = mesh.axis(axis).index * rows
    return start, start + rows


def _local(ids: torch.Tensor, start: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-local row of each id (clamped into the shard) and whether the
    id lies in the shard."""
    local = ids - start
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def masked_gather(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's part of a lookup: the rows of ``ids`` in its shard, zeros
    elsewhere; shape ``ids.shape + table.shape[1:]``."""
    start, stop = shard_range(table_shard, mesh, axis)
    local, inside = _local(ids.reshape(-1), start, stop - start)
    got = table_shard.index_select(0, local)
    got = torch.where(inside.view((-1,) + (1,) * (got.dim() - 1)), got, torch.zeros((), dtype=got.dtype,
                                                                                       device=got.device))
    return got.reshape(tuple(ids.shape) + tuple(table_shard.shape[1:]))


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids, mesh, axis):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.axis, ctx.shape = mesh, axis, table_shard.shape
        return psum(masked_gather(table_shard, ids, mesh, axis), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        start = ctx.mesh.axis(ctx.axis).index * ctx.shape[0]
        local, inside = _local(ids.reshape(-1), start, ctx.shape[0])
        g = g.reshape((-1,) + tuple(ctx.shape[1:]))
        g = torch.where(inside.view((-1,) + (1,) * (g.dim() - 1)), g, torch.zeros((), dtype=g.dtype,
                                                                                  device=g.device))
        grad.index_add_(0, local, g)
        return grad, None, None, None


def sharded_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """Rows ``ids`` (any shape) of a table row-sharded over ``axis``, on every
    rank of the axis: masked local gather + psum. Differentiable with
    respect to the shard (the masked local scatter of the cotangent)."""
    if mesh.axis(axis).size == 1:
        return table_shard[ids]
    return _Lookup.apply(table_shard, ids, mesh, axis)


def sharded_scatter_add(
    table_shard: torch.Tensor, ids: torch.Tensor, updates: torch.Tensor, mesh: Mesh, axis: str = "model"
) -> torch.Tensor:
    """``table[ids] += updates`` for a table row-sharded over ``axis``, in
    place: each rank adds the update rows that land in its shard (ids and
    updates the same on every rank of the axis). No collective."""
    ids = ids.reshape(-1)
    updates = updates.reshape((ids.shape[0],) + tuple(table_shard.shape[1:]))
    start, stop = shard_range(table_shard, mesh, axis)
    local, inside = _local(ids, start, stop - start)
    # rows outside the shard add zeros to a clamped row (x + 0 == x): no
    # data-dependent shape, so no sync with the host
    zero = torch.zeros((), dtype=updates.dtype, device=updates.device)
    updates = torch.where(inside.view((-1,) + (1,) * (updates.dim() - 1)), updates, zero)
    return scatter_add_rows(table_shard, local, updates)

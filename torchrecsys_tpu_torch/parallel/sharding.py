"""Shardings of the train state and the batches (port of
``torchrecsys_tpu/parallel/sharding.py``).

A :class:`Sharding` names, per dimension, the mesh axis that splits it
(``jax.sharding.PartitionSpec``): ``("model", None)`` for an embedding
table, whose rows split over ``model`` (after ``padded_rows``, so every
rank holds the same count); ``("model",)`` for its per-row accumulator;
``()`` for what every rank holds whole (dense parameters, the model
state, ``step``, the generator); ``("data",)`` for a batch. Where JAX
places a global array on devices, the port keeps on each rank the piece
its coordinates select (:func:`shard`), and :func:`gather_state` rebuilds
the whole state on every rank (for ``save`` and for checks).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from torchrecsys_tpu_torch.parallel.mesh import Mesh, all_gather


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    mesh: Mesh
    spec: Tuple[Any, ...]


def table_sharding(mesh: Mesh) -> Sharding:
    """Row-sharded embedding table: (rows, dim) split over 'model'."""
    return Sharding(mesh, ("model", None))


def table_acc_sharding(mesh: Mesh) -> Sharding:
    """Per-row accumulator: (rows,) split over 'model'."""
    return Sharding(mesh, ("model",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """Batch arrays: leading axis split over 'data'."""
    return Sharding(mesh, ("data",))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def state_shardings(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The sharding of every leaf of a Trainer state (:86-106)."""
    ts, acc, rep = table_sharding(mesh), table_acc_sharding(mesh), replicated(mesh)
    return {
        "tables": {k: ts for k in state["tables"]},
        "dense": _tree_map(lambda _: rep, state["dense"]),
        "model_state": _tree_map(lambda _: rep, state["model_state"]),
        "emb_opt": {k: {kk: (acc if kk == "acc" else rep) for kk in v} for k, v in state["emb_opt"].items()},
        "dense_opt": _tree_map(lambda _: rep, state.get("dense_opt")),
        "step": rep,
        "rng": rep,
    }


def shard(x: Any, sharding: Sharding) -> Any:
    """This rank's piece of the whole tensor ``x`` on its device: dim 0
    split over the spec's first axis (if any); anything else as it is."""
    mesh = sharding.mesh
    if not isinstance(x, torch.Tensor):
        return x
    x = x.to(mesh.device)
    if not sharding.spec or sharding.spec[0] is None:
        return x
    ax = mesh.axis(sharding.spec[0])
    if x.shape[0] % ax.size:
        raise ValueError(
            f"{x.shape[0]} rows do not split over {sharding.spec[0]}={ax.size}: tables are split after "
            "padded_rows (a multiple of 64), so the axis must divide that"
        )
    rows = x.shape[0] // ax.size
    return x[ax.index * rows : (ax.index + 1) * rows].clone()


def shard_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A whole Trainer state as this rank's piece of it (:109-113): tables
    and their accumulators row-split over 'model', the rest replicated."""
    specs = state_shardings(state, mesh)
    out = dict(state)
    for key in ("tables", "dense", "model_state", "emb_opt", "dense_opt"):
        out[key] = _zip_map(shard, state.get(key), specs[key])
    return out


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def gather_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The whole state on every rank from each rank's piece: the tables and
    accumulators all-gathered over 'model' (exact)."""
    if mesh.shape["model"] == 1:
        return dict(state)
    out = dict(state)
    out["tables"] = {k: all_gather(v, mesh, "model") for k, v in state["tables"].items()}
    out["emb_opt"] = {
        k: {kk: (all_gather(a, mesh, "model") if kk == "acc" else a) for kk, a in v.items()}
        for k, v in state["emb_opt"].items()
    }
    return out


def batch_splits(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """Every ``data`` rank's [start, stop) of n batch rows, in rank order:
    ``[r n // d, (r + 1) n // d)``, contiguous, so a batch that does not
    divide the axis splits as evenly as it can (JAX's GSPMD step takes
    such a batch whole, its loss and statistics over every row)."""
    d = mesh.shape["data"]
    if n < d:
        raise ValueError(f"a batch of {n} rows cannot give each of data={d} ranks a row")
    return [(r * n // d, (r + 1) * n // d) for r in range(d)]


def batch_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """[start, stop) of this rank's 'data' shard of n batch rows
    (:func:`batch_splits`)."""
    return batch_splits(n, mesh)[mesh.data_rank]

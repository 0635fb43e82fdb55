"""Rowwise-adagrad state, the augmented table layout and the dense
optimizers (port of ``torchrecsys_tpu/train/optim.py:36-47``, :123-196).

Rowwise adagrad keeps one f32 accumulator per table row. For the length
of an epoch the accumulator rides as the last column of an augmented
``(R, D+1)`` table, so one row gather and one row scatter carry both the
parameter and its accumulator (the fused pairwise step packs these
further into 128-wide rows, ops/fused_pairwise.py; the autograd step
updates the augmented tables with :func:`apply_embedding_updates_fused`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch


def init_embedding_opt(kind: str, tables: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero accumulators, one (R,) f32 per table, on each table's device."""
    if kind != "rowwise_adagrad":
        raise ValueError(f"unknown embedding optimizer {kind!r}")
    return {
        name: {"acc": torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device)}
        for name, t in tables.items()
    }


def supports_fused_layout(kind: str, tables: Mapping[str, torch.Tensor]) -> bool:
    """The augmented layout needs f32 tables (the accumulator shares their
    dtype)."""
    return kind == "rowwise_adagrad" and all(t.dtype == torch.float32 for t in tables.values())


def augment_tables(
    tables: Mapping[str, torch.Tensor], opt_state: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """(R, D) tables + (R,) accumulators -> (R, D+1) augmented tables."""
    return {
        name: torch.cat([t, opt_state[name]["acc"][:, None]], dim=1)
        for name, t in tables.items()
    }


def split_augmented(
    aug: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Inverse of :func:`augment_tables` (contiguous copies)."""
    tables = {name: a[:, :-1].contiguous() for name, a in aug.items()}
    opt_state = {name: {"acc": a[:, -1].contiguous()} for name, a in aug.items()}
    return tables, opt_state


# [(ids (any shape), g (ids + [d]), acc_old (ids))] per gather site
FusedRowGrads = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def apply_embedding_updates_fused(
    lr: float,
    aug_tables: Mapping[str, torch.Tensor],
    grads: Mapping[str, FusedRowGrads],
    eps: float = 1e-10,
) -> None:
    """Rowwise-adagrad step on augmented tables, IN PLACE (optim.py:149-179):
    one ``index_add_`` per table of ``[-lr * g * rsqrt(acc_old + msq +
    eps), msq]`` rows, ``msq = mean(g^2)``. A row that occurs twice in one
    batch scales each occurrence by ``acc_old + its own msq``; the
    accumulator still gains every occurrence's msq."""
    for name, sites in grads.items():
        if not sites:
            continue
        aug = aug_tables[name]
        d = aug.shape[-1] - 1
        ids = torch.cat([i.reshape(-1) for i, _, _ in sites])
        g = torch.cat([gr.reshape(-1, d).float() for _, gr, _ in sites])
        acc_old = torch.cat([a.reshape(-1).float() for _, _, a in sites])
        msq = torch.mean(g * g, dim=-1)
        scale = torch.rsqrt(acc_old + msq + eps)
        upd = torch.cat([(-lr * g) * scale[:, None], msq[:, None]], dim=1)
        aug.index_add_(0, ids, upd.to(aug.dtype))


# ---------------------------------------------------------------------------
# Dense optimizers (make_dense_optimizer, optim.py:182-196): optax's adam,
# adamw, adagrad and sgd with optax's default hyperparameters, as functional
# updates on the nested dense dict with an explicit state that carries over
# from optax's (utils/convert.py::dense_opt_from_jax). The step count is a
# host int, so no update syncs with the device.
# ---------------------------------------------------------------------------

_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam / adamw
_WEIGHT_DECAY = 1e-4  # optax.adamw
_ADAGRAD_INIT, _ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad (scale_by_rss)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested dicts and lists of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves: List[torch.Tensor]):
    """Inverse of :func:`tree_leaves` against a tree of the same shape."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)

    return build(tree)


def init_dense_opt(kind: str, dense) -> Dict[str, Any]:
    """optax's ``init`` for ``kind``: adam/adamw ``{"count", "mu", "nu"}``
    (zeros), adagrad ``{"sum_of_squares"}`` (0.1), sgd ``{}``."""
    if kind in ("adam", "adamw"):
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, dense),
            "nu": tree_map(torch.zeros_like, dense),
        }
    if kind == "adagrad":
        return {"sum_of_squares": tree_map(lambda p: torch.full_like(p, _ADAGRAD_INIT), dense)}
    if kind == "sgd":
        return {}
    raise ValueError(f"unknown dense optimizer {kind!r}")


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def apply_dense_update(kind: str, lr: float, dense, grads, opt_state) -> Tuple[Any, Dict[str, Any]]:
    """One optax step: ``(new dense, new state)``. ``grads`` has the shape
    of ``dense`` (a parameter without a gradient takes zeros)."""
    if kind in ("adam", "adamw"):
        count = opt_state["count"] + 1
        mu = tree_map(lambda g, m: (1 - _B1) * g + _B1 * m, grads, opt_state["mu"])
        nu = tree_map(lambda g, v: (1 - _B2) * (g * g) + _B2 * v, grads, opt_state["nu"])
        c1, c2 = _bias_correction(_B1, count), _bias_correction(_B2, count)

        def step(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + _ADAM_EPS)
            if kind == "adamw":
                u = u + _WEIGHT_DECAY * p
            return p + u * -lr

        return tree_map(step, dense, mu, nu), {"count": count, "mu": mu, "nu": nu}
    if kind == "adagrad":
        sos = tree_map(lambda g, t: g * g + t, grads, opt_state["sum_of_squares"])

        def step(p, g, t):
            inv = torch.where(t > 0, torch.rsqrt(t + _ADAGRAD_EPS), torch.zeros_like(t))
            return p + (inv * g) * -lr

        return tree_map(step, dense, grads, sos), {"sum_of_squares": sos}
    if kind == "sgd":
        return tree_map(lambda p, g: p + g * -lr, dense, grads), {}
    raise ValueError(f"unknown dense optimizer {kind!r}")

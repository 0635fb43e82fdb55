"""Embedding optimizers, the augmented table layout, the dense optimizers
and the lr schedules (port of ``torchrecsys_tpu/train/optim.py``).

Rowwise adagrad keeps one f32 accumulator per table row. For the length
of an epoch the accumulator rides as the last column of an augmented
``(R, D+1)`` table, so one row gather and one row scatter carry both the
parameter and its accumulator (the fused pairwise step packs these
further into 128-wide rows, ops/fused_pairwise.py; the autograd step
updates the augmented tables with :func:`apply_embedding_updates_fused`).
``embedding_optimizer="sgd"`` and ``fused_embedding_update=False`` take
the plain tables with a separate accumulator instead
(:func:`apply_embedding_updates`, :49-121): there a row that occurs twice
in one batch scales every occurrence by the accumulator after all of
them.

:func:`make_lr_schedule` (:199-245) evaluates optax's four schedules on
the host, each op in ``np.float32`` in optax's own order (``cos`` and
``pow`` through the C library's f32 functions, as the JAX package's CPU
backend computes them), so a value equals optax's evaluated op by op.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def init_embedding_opt(kind: str, tables: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Rowwise adagrad: zero accumulators, one (R,) f32 per table, on each
    table's device; sgd: no state (:36-46)."""
    if kind == "rowwise_adagrad":
        return {
            name: {"acc": torch.zeros((t.shape[0],), dtype=torch.float32, device=t.device)}
            for name, t in tables.items()
        }
    if kind == "sgd":
        return {name: {} for name in tables}
    raise ValueError(f"unknown embedding optimizer {kind!r}")


# [(ids (any shape), g (ids + [d]))] per gather site
RowGrads = List[Tuple[torch.Tensor, torch.Tensor]]


def apply_embedding_updates(
    kind: str,
    lr: float,
    tables: Mapping[str, torch.Tensor],
    opt_state: Mapping[str, Any],
    grads: Mapping[str, RowGrads],
    eps: float = 1e-10,
    scatter: Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Any]] = None,
    take: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> None:
    """Sparse row updates of the plain (R, D) tables and their optimizer
    state, IN PLACE (:49-121). Rowwise adagrad: ``acc[ids] += mean(g^2)``
    (every duplicate added first), then each occurrence adds
    ``-lr * g * rsqrt(acc[ids] + eps)``; sgd adds ``-lr * g``.
    ``scatter(target, ids, rows)`` replaces each ``index_add_`` and
    ``take(acc, ids)`` the accumulator read (a mesh's fixed-order or
    shard-masked scatter and its sharded lookup)."""
    if scatter is None:
        scatter = lambda target, ids, rows: target.index_add_(0, ids, rows.to(target.dtype))  # noqa: E731
    for name, sites in grads.items():
        if not sites:
            continue
        table = tables[name]
        d = table.shape[-1]
        ids = torch.cat([i.reshape(-1) for i, _ in sites])
        g = torch.cat([gr.reshape(-1, d).float() for _, gr in sites])
        if kind == "rowwise_adagrad":
            acc = opt_state[name]["acc"]
            scatter(acc, ids, torch.mean(g * g, dim=-1))
            scale = torch.rsqrt((acc[ids] if take is None else take(acc, ids)) + eps)
            delta = (-lr * g) * scale[:, None]
        elif kind == "sgd":
            delta = -lr * g
        else:
            raise ValueError(f"unknown embedding optimizer {kind!r}")
        scatter(table, ids, delta.to(table.dtype))


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
    scatter: Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Any]] = None,
) -> None:
    """Rowwise-adagrad step on augmented tables, IN PLACE (optim.py:149-179):
    one ``index_add_`` per table of ``[-lr * g * rsqrt(acc_old + msq +
    eps), msq]`` rows, ``msq = mean(g^2)``. A row that occurs twice in one
    batch scales each occurrence by ``acc_old + its own msq``; the
    accumulator still gains every occurrence's msq. ``scatter(table, ids,
    rows)`` replaces the ``index_add_`` (a mesh's fixed-order or
    shard-masked scatter)."""
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
        if scatter is None:
            aug.index_add_(0, ids, upd.to(aug.dtype))
        else:
            scatter(aug, ids, upd)


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


def init_dense_opt(kind: str, dense, schedule: bool = False) -> Dict[str, Any]:
    """optax's ``init`` for ``kind``: adam/adamw ``{"count", "mu", "nu"}``
    (zeros), adagrad ``{"sum_of_squares"}`` (0.1), sgd ``{}``; under an lr
    schedule also ``"schedule_count"`` (optax's ``ScaleByScheduleState``:
    the number of updates made, the count the schedule is read at)."""
    if kind in ("adam", "adamw"):
        out = {
            "count": 0,
            "mu": tree_map(torch.zeros_like, dense),
            "nu": tree_map(torch.zeros_like, dense),
        }
    elif kind == "adagrad":
        out = {"sum_of_squares": tree_map(lambda p: torch.full_like(p, _ADAGRAD_INIT), dense)}
    elif kind == "sgd":
        out = {}
    else:
        raise ValueError(f"unknown dense optimizer {kind!r}")
    if schedule:
        out["schedule_count"] = 0
    return out


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def apply_dense_update(
    kind: str, lr: float, dense, grads, opt_state, schedule: Optional[Callable[[int], float]] = None
) -> Tuple[Any, Dict[str, Any]]:
    """One optax step: ``(new dense, new state)``. ``grads`` has the shape
    of ``dense`` (a parameter without a gradient takes zeros). With a
    ``schedule`` the lr is ``schedule(opt_state["schedule_count"])`` and the
    count goes up by one, as optax's ``scale_by_schedule`` does; adam's
    bias correction reads its own ``count``."""
    if schedule is not None:
        sc = opt_state.get("schedule_count", 0)
        lr = schedule(sc)
        new, state = apply_dense_update(kind, lr, dense, grads, opt_state)
        return new, dict(state, schedule_count=sc + 1)
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


# ---------------------------------------------------------------------------
# lr schedules (make_lr_schedule, optim.py:199-245)
# ---------------------------------------------------------------------------

_F = np.float32


@functools.lru_cache(maxsize=1)
def _libm():
    """The C library's f32 ``cosf`` and ``powf``: the ones the JAX
    package's CPU backend computes ``jnp.cos`` / ``jnp.power`` of f32 with
    (bit for bit; numpy's f32 versions round differently)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    lib.powf.restype, lib.powf.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return lib


def _cosine(base_lr: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: ``count = min(step, T)``, ``0.5 * (1 +
    cos(pi * count / T))``, ``(1 - alpha) * c + alpha``, times ``base_lr``,
    each op in f32."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}."
        )
    t = _F(float(decay_steps))

    def fn(step: int) -> float:
        count = min(_F(step), t)
        x = (_F(math.pi) * count) / t
        c = _F(0.5) * (_F(1.0) + _F(_libm().cosf(float(x))))
        decayed = _F(1.0 - alpha) * c + _F(alpha)
        return float(_F(base_lr) * decayed)

    return fn


def _piecewise(base_lr: float, boundaries: Dict[int, float]) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule: each boundary the step has
    reached multiplies the f32 value by its f32 scale."""
    if not all(v >= 0.0 for v in boundaries.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
    items = sorted(boundaries.items())

    def fn(step: int) -> float:
        v = _F(base_lr)
        for threshold, scale in items:
            if step >= threshold:
                v = _F(scale) * v
        return float(v)

    return fn


def _exponential(base_lr: float, steps: int, rate: float, staircase: bool) -> Callable[[int], float]:
    """optax.exponential_decay: ``base_lr * rate ** (step / T)`` in f32 (the
    exponent floored with ``staircase``), ``base_lr`` at step <= 0."""
    if steps <= 0 or rate == 0:
        return lambda step: float(_F(base_lr))

    def fn(step: int) -> float:
        if step <= 0:
            return float(_F(base_lr))
        p = _F(step) / _F(steps)
        if staircase:
            p = np.floor(p)
        return float(_F(base_lr) * _F(_libm().powf(float(_F(rate)), float(p))))

    return fn


def _linear(base_lr: float, end_value: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (a polynomial schedule of power 1):
    ``(base_lr - end) * (1 - clip(step, 0, T) / T) + end``, the first
    difference in float64 as Python forms it, the rest in f32."""
    if steps <= 0:
        return lambda step: float(_F(base_lr))

    def fn(step: int) -> float:
        frac = _F(1.0) - _F(min(max(step, 0), steps)) / _F(steps)
        return float(_F(base_lr - end_value) * frac + _F(end_value))

    return fn


def make_lr_schedule(base_lr: float, spec) -> Optional[Callable[[int], float]]:
    """``TrainConfig.lr_schedule`` -> ``step -> lr`` (a host float, f32
    valued), or None for the constant ``base_lr``. ``spec`` is a callable
    (used as is, its value rounded to f32) or a dict:

    - ``{"kind": "cosine", "decay_steps": N[, "alpha": a]}``
    - ``{"kind": "step", "boundaries_and_scales": {step: scale, ...}}``
    - ``{"kind": "exponential", "transition_steps": N, "decay_rate": r[,
      "staircase": bool]}``
    - ``{"kind": "linear", "transition_steps": N[, "end_value": v]}``

    The step is the global step counter (``state["step"]`` plus the step's
    index in its epoch), so the schedule runs on across epochs and ``fit``
    calls."""
    if spec is None:
        return None
    if callable(spec):
        return lambda step: float(_F(float(spec(step))))
    kind = spec.get("kind")
    if kind == "cosine":
        return _cosine(base_lr, int(spec["decay_steps"]), float(spec.get("alpha", 0.0)))
    if kind == "step":
        return _piecewise(base_lr, {int(k): float(v) for k, v in spec["boundaries_and_scales"].items()})
    if kind == "exponential":
        return _exponential(base_lr, int(spec["transition_steps"]), float(spec["decay_rate"]),
                            bool(spec.get("staircase", False)))
    if kind == "linear":
        return _linear(base_lr, float(spec.get("end_value", 0.0)), int(spec["transition_steps"]))
    raise ValueError(f"unknown lr_schedule spec {spec!r}")

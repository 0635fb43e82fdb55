"""Weight and training-state carry-over from the JAX package.

The JAX package keeps its embedding tables in ``state["tables"]``: one
array per table name, rows padded to ``ROW_ALIGN``. :func:`tables_from_jax`
takes those tables as numpy arrays (``np.asarray`` of each), checks them
against the port model's ``table_specs`` and returns the port's tensors,
so a port ``RecSys`` can serve, or go on training, weights trained by the
JAX package (``RecSys.load_jax_tables``). The names and widths come from
the model: FM's width-1 ``linear_*`` tables (and their accumulators) carry
over like Linear's biases. :func:`dense_from_jax` and
:func:`model_state_from_jax` carry the dense parameters (the MLP tower,
``state["dense"]``) and the model state (batch-norm running statistics,
``state["model_state"]``), checked against the port model's own layout;
:func:`dense_opt_from_jax` the optax state of the dense optimizer
(``state["dense_opt"]``). :func:`train_state_from_jax` carries all of
these, the rowwise-adagrad accumulators (``state["emb_opt"]``) and the
step counter. :func:`checkpoint_from_jax` writes a port checkpoint from a
JAX checkpoint's state, ``aux.pkl`` and ``schema.json``, so a model the
JAX package trained reaches ``RecSys.load`` without its dataset; an EASE
checkpoint carries its ``B`` and ``aux["ease_csr"]``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from torchrecsys_tpu_torch.models.base import RecModel, padded_rows

# config fields of the JAX package the port has no counterpart for: its
# Pallas backend switches (the port's kernels follow the device)
JAX_ONLY_FIELDS = {
    "model_cfg": ("pallas_tower",),
    "train_cfg": ("pallas_step", "pallas_softmax"),
}


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A copy of ``arr`` as a CPU tensor (JAX hands out read-only arrays)."""
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: move the raw bits
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def tables_from_jax(
    tables: Mapping[str, np.ndarray], model: RecModel, device
) -> Dict[str, torch.Tensor]:
    """JAX ``state["tables"]`` (as numpy) -> the port's tables on ``device``.

    Raises ValueError on a missing or extra table name, a shape other than
    ``(padded_rows(spec.rows), spec.dim)``, or a dtype other than the
    model's ``param_dtype``."""
    specs = model.table_specs()
    if set(tables) != set(specs):
        raise ValueError(
            f"table names {sorted(tables)} do not match the model's "
            f"{sorted(specs)}"
        )
    want_dtype = str(model.param_dtype).removeprefix("torch.")
    out: Dict[str, torch.Tensor] = {}
    for name, spec in sorted(specs.items()):
        arr = tables[name]
        want = (padded_rows(spec.rows), spec.dim)
        if tuple(arr.shape) != want:
            raise ValueError(f"table {name!r}: shape {tuple(arr.shape)} != {want}")
        if arr.dtype.name != want_dtype:
            raise ValueError(f"table {name!r}: dtype {arr.dtype.name} != {want_dtype}")
        out[name] = _to_tensor(arr).to(device)
    return out


def emb_opt_from_jax(
    emb_opt: Optional[Mapping[str, Mapping[str, np.ndarray]]],
    tables: Mapping[str, torch.Tensor],
    device,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``state["emb_opt"]`` (``{name: {"acc": (R,) f32}}`` as numpy,
    or ``{name: {}}`` under ``embedding_optimizer="sgd"``) -> the port's on
    ``device``; ``None`` gives zero accumulators. Raises ValueError on a
    missing name or a shape other than the table's rows."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in tables.items():
        if emb_opt is not None and name in emb_opt and not emb_opt[name]:
            out[name] = {}  # sgd keeps no state
            continue
        if emb_opt is None:
            acc = torch.zeros((t.shape[0],), dtype=torch.float32, device=device)
        else:
            if name not in emb_opt or "acc" not in emb_opt[name]:
                raise ValueError(f"emb_opt has no accumulator for table {name!r}")
            arr = np.asarray(emb_opt[name]["acc"])
            if arr.shape != (t.shape[0],) or arr.dtype != np.float32:
                raise ValueError(
                    f"emb_opt[{name!r}]: {arr.shape} {arr.dtype} != ({t.shape[0]},) float32"
                )
            acc = _to_tensor(arr).to(device)
        out[name] = {"acc": acc}
    return out


def _tree_from_jax(tree: Any, template: Any, what: str, device) -> Any:
    """A nested dict/list of numpy arrays -> the same tree of tensors on
    ``device``, checked against ``template`` (a tree of tensors): the same
    keys, list lengths, shapes and dtypes."""
    if isinstance(template, dict):
        if not isinstance(tree, Mapping) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"{what}: keys {got} != {sorted(template)}")
        return {k: _tree_from_jax(tree[k], template[k], f"{what}[{k!r}]", device) for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"{what}: expected a list of {len(template)}")
        return [_tree_from_jax(a, t, f"{what}[{i}]", device) for i, (a, t) in enumerate(zip(tree, template))]
    arr = np.asarray(tree)
    want = str(template.dtype).removeprefix("torch.")
    if tuple(arr.shape) != tuple(template.shape) or arr.dtype.name != want:
        raise ValueError(f"{what}: {arr.shape} {arr.dtype.name} != {tuple(template.shape)} {want}")
    return _to_tensor(arr).to(device)


def dense_from_jax(dense: Any, model: RecModel, device) -> Any:
    """JAX ``state["dense"]`` (numpy tree: the MLP's tower, NeuCF's layers
    and output layer) -> the port's dense tree on ``device``, in the layout
    of ``model.init_dense``."""
    return _tree_from_jax(dense, model.init_dense(torch.Generator()), "dense", device)


def model_state_from_jax(model_state: Any, model: RecModel, device) -> Any:
    """JAX ``state["model_state"]`` (numpy tree; the MLP's batch-norm
    running means and variances) -> the port's on ``device``."""
    return _tree_from_jax(model_state, model.init_state(), "model_state", device)


def dense_opt_from_jax(opt_state: Any, kind: str, dense: Any, device) -> Dict[str, Any]:
    """The optax state of ``make_dense_optimizer(kind, lr, schedule)``
    (numpy tree: a tuple of optax states) -> the port's dense optimizer
    state on ``device`` (train/optim.py::init_dense_opt's layout), checked
    against ``dense`` (the port's dense tree). A ``ScaleByScheduleState``
    (the state of an lr schedule) carries its count over as
    ``"schedule_count"``; adam's own ``count`` comes from its
    ``ScaleByAdamState``."""
    from torchrecsys_tpu_torch.train.optim import init_dense_opt

    parts = list(opt_state) if isinstance(opt_state, (list, tuple)) else [opt_state]
    sched = [p for p in parts if type(p).__name__ == "ScaleByScheduleState"]
    parts = [p for p in parts if type(p).__name__ != "ScaleByScheduleState"]
    template = init_dense_opt(kind, dense, schedule=bool(sched))
    out: Dict[str, Any] = {}
    for key in template:
        if key == "schedule_count":
            out[key] = int(np.asarray(sched[0].count))
            continue
        found = [getattr(p, key) for p in parts if key in getattr(p, "_fields", ())]
        if not found:
            raise ValueError(f"dense_opt: the {kind!r} state has no {key!r}")
        if key == "count":
            out[key] = int(np.asarray(found[0]))
        else:
            out[key] = _tree_from_jax(found[0], template[key], f"dense_opt.{key}", device)
    return out


def train_state_from_jax(
    state_np: Mapping[str, Any], model: RecModel, device, dense_optimizer: str = "adam"
) -> Dict[str, Any]:
    """The JAX trainer's ``{"tables", "dense", "model_state", "emb_opt":
    {name: {"acc"}}, "dense_opt", "step"}`` (numpy) -> the port trainer's
    state on ``device``. ``dense``, ``model_state`` and ``dense_opt`` (the
    state of ``dense_optimizer``) may be absent: the model's fresh (empty
    for Linear) ones, and optax's init, take their place."""
    tables = tables_from_jax(state_np["tables"], model, device)
    dense = (
        dense_from_jax(state_np["dense"], model, device) if "dense" in state_np
        else model.init_dense(torch.Generator(device=device))
    )
    opt = state_np.get("dense_opt")
    return {
        "tables": tables,
        "dense": dense,
        "model_state": (
            model_state_from_jax(state_np["model_state"], model, device)
            if "model_state" in state_np else model.init_state(device)
        ),
        "emb_opt": emb_opt_from_jax(state_np["emb_opt"], tables, device),
        "dense_opt": None if opt is None else dense_opt_from_jax(opt, dense_optimizer, dense, device),
        "step": int(np.asarray(state_np.get("step", 0))),
        "rng": None,
    }


def checkpoint_from_jax(
    out_dir: str, state: Mapping[str, Any], aux: Mapping[str, Any], schema: Mapping[str, Any]
) -> None:
    """Write a port checkpoint to ``out_dir`` (utils/checkpoint.py) from a
    JAX checkpoint: ``state`` its train state read into numpy, ``aux`` its
    ``aux.pkl`` dict and ``schema`` its ``schema.json`` dict. The configs
    lose :data:`JAX_ONLY_FIELDS`; the state goes through
    :func:`train_state_from_jax` against the port model of the configs
    (the JAX generator key is not carried: a fit from the result draws
    from a generator seeded with the train config's seed). An EASE
    checkpoint's state is ``{"b": (I, I) f32}``, checked against the
    schema; its CSR rides ``aux["ease_csr"]`` as it is."""
    from torchrecsys_tpu_torch.config import DataSchema, ModelConfig
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.utils.checkpoint import save_checkpoint

    aux = dict(aux)
    for key, drop in JAX_ONLY_FIELDS.items():
        if aux.get(key) is not None:
            aux[key] = {k: v for k, v in aux[key].items() if k not in drop}
    data_schema = DataSchema.from_dict(schema)
    if aux["model_cfg"]["net_type"] == "ease":
        n = data_schema.num_items
        b = _tree_from_jax(state["b"], torch.empty((n, n), dtype=torch.float32), "b", "cpu")
        save_checkpoint(out_dir, {"b": b}, data_schema, aux=aux)
        return
    model = build_model(data_schema, ModelConfig(**aux["model_cfg"]))
    kind = (aux.get("train_cfg") or {}).get("dense_optimizer", "adam")
    port_state = train_state_from_jax(state, model, "cpu", dense_optimizer=kind)
    save_checkpoint(out_dir, port_state, data_schema, aux=aux)

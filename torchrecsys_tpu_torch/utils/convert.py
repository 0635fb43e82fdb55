"""Weight and training-state carry-over from the JAX package.

The JAX package keeps its embedding tables in ``state["tables"]``: one
array per table name, rows padded to ``ROW_ALIGN``. :func:`tables_from_jax`
takes those tables as numpy arrays (``np.asarray`` of each), checks them
against the port model's ``table_specs`` and returns the port's tensors,
so a port ``RecSys`` can serve, or go on training, weights trained by the
JAX package (``RecSys.load_jax_tables``). :func:`train_state_from_jax`
also carries the rowwise-adagrad accumulators (``state["emb_opt"]``) and
the step counter.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from torchrecsys_tpu_torch.models.base import RecModel, padded_rows


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
    """JAX ``state["emb_opt"]`` (``{name: {"acc": (R,) f32}}`` as numpy)
    -> the port's accumulators on ``device``; ``None`` gives zeros.
    Raises ValueError on a missing name or a shape other than the table's
    rows."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in tables.items():
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


def train_state_from_jax(
    state_np: Mapping[str, Any], model: RecModel, device
) -> Dict[str, Any]:
    """The JAX trainer's ``{"tables", "emb_opt": {name: {"acc"}}, "step"}``
    (numpy) -> the port trainer's state on ``device``, with the dense,
    model-state and rng entries the port's state carries."""
    tables = tables_from_jax(state_np["tables"], model, device)
    return {
        "tables": tables,
        "dense": {},
        "model_state": {},
        "emb_opt": emb_opt_from_jax(state_np["emb_opt"], tables, device),
        "step": int(np.asarray(state_np.get("step", 0))),
        "rng": None,
    }

"""Weight carry-over from the JAX package.

The JAX package keeps its embedding tables in ``state["tables"]``: one
array per table name, rows padded to ``ROW_ALIGN``. :func:`tables_from_jax`
takes those tables as numpy arrays (``np.asarray`` of each), checks them
against the port model's ``table_specs`` and returns the port's tensors,
so a port ``RecSys`` that never trained can serve weights trained by the
JAX package (``RecSys.load_jax_tables``).
"""

from __future__ import annotations

from typing import Dict, Mapping

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

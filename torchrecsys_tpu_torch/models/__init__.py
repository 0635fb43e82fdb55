"""Model factory (port of ``torchrecsys_tpu/models/__init__.py``).

The ported slices cover ``linear``, ``fm``, ``mlp``, ``neucf``, ``lstm``
and ``sasrec``. ``ease`` is still to be ported (ROADMAP.md, queue A) and
raises ``NotImplementedError``.
"""

from __future__ import annotations

from torchrecsys_tpu_torch.config import DataSchema, ModelConfig
from torchrecsys_tpu_torch.models.base import RecModel, TableSpec
from torchrecsys_tpu_torch.models.fm import FMModel
from torchrecsys_tpu_torch.models.linear import LinearModel
from torchrecsys_tpu_torch.models.lstm import LSTMModel
from torchrecsys_tpu_torch.models.mlp import MLPModel
from torchrecsys_tpu_torch.models.neucf import NeuCFModel
from torchrecsys_tpu_torch.models.sasrec import SASRecModel

MODEL_REGISTRY = {
    "linear": LinearModel, "fm": FMModel, "mlp": MLPModel, "neucf": NeuCFModel,
    "lstm": LSTMModel, "sasrec": SASRecModel,
}

# net_type -> the ROADMAP.md item that ports it
_NOT_YET_PORTED = {"ease": "§A item 11 (EASE)"}


def build_model(schema: DataSchema, cfg: ModelConfig) -> RecModel:
    if cfg.net_type in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"net_type {cfg.net_type!r} is not ported to torchrecsys_tpu_torch "
            f"yet: ROADMAP.md item {_NOT_YET_PORTED[cfg.net_type]}"
        )
    try:
        cls = MODEL_REGISTRY[cfg.net_type]
    except KeyError:
        raise ValueError(
            f"unknown net_type {cfg.net_type!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(schema, cfg)


__all__ = [
    "MODEL_REGISTRY", "build_model", "RecModel", "TableSpec", "LinearModel", "FMModel", "MLPModel",
    "NeuCFModel", "LSTMModel", "SASRecModel",
]

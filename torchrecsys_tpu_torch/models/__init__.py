"""Model factory (port of ``torchrecsys_tpu/models/__init__.py``).

``build_model`` builds the gradient-trained nets: ``linear``, ``fm``,
``mlp``, ``neucf``, ``lstm``, ``sasrec`` and ``hstu`` (the last has no
JAX counterpart). ``ease`` has no gradient training: :class:`EASE` is
built directly (the facade does so for ``net_type="ease"``), and
``build_model`` refuses it as JAX's does.
"""

from __future__ import annotations

from torchrecsys_tpu_torch.config import DataSchema, ModelConfig
from torchrecsys_tpu_torch.models.base import RecModel, TableSpec
from torchrecsys_tpu_torch.models.ease import EASE
from torchrecsys_tpu_torch.models.fm import FMModel
from torchrecsys_tpu_torch.models.hstu import HSTUModel
from torchrecsys_tpu_torch.models.linear import LinearModel
from torchrecsys_tpu_torch.models.lstm import LSTMModel
from torchrecsys_tpu_torch.models.mlp import MLPModel
from torchrecsys_tpu_torch.models.neucf import NeuCFModel
from torchrecsys_tpu_torch.models.sasrec import SASRecModel

MODEL_REGISTRY = {
    "linear": LinearModel, "fm": FMModel, "mlp": MLPModel, "neucf": NeuCFModel,
    "lstm": LSTMModel, "sasrec": SASRecModel, "hstu": HSTUModel,
}


def build_model(schema: DataSchema, cfg: ModelConfig) -> RecModel:
    try:
        cls = MODEL_REGISTRY[cfg.net_type]
    except KeyError:
        raise ValueError(
            f"unknown net_type {cfg.net_type!r}; available: {sorted(MODEL_REGISTRY)} "
            "(plus 'ease' via torchrecsys_tpu_torch.models.EASE)"
        ) from None
    return cls(schema, cfg)


__all__ = [
    "MODEL_REGISTRY", "build_model", "RecModel", "TableSpec", "LinearModel", "FMModel", "MLPModel",
    "NeuCFModel", "LSTMModel", "SASRecModel", "HSTUModel", "EASE",
]

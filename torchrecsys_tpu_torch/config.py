"""Configuration dataclasses (port of ``torchrecsys_tpu/config.py:17-107``).

Only the fields the serving slice reads are kept. ``TrainConfig`` and the
train-kernel switches arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class DataSchema:
    """Static shape/vocab information about a dataset (config.py:16-56).

    ``num_users``/``num_items`` are encoded-vocab sizes;
    ``metadata_vocab_sizes`` holds one vocab size per metadata feature and
    ``metadata_width`` the fixed multi-hot bucket width shared by all
    features."""

    num_users: int
    num_items: int
    metadata_names: Tuple[str, ...] = ()
    metadata_vocab_sizes: Tuple[int, ...] = ()
    metadata_width: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters the serving slice reads (config.py:59-89).

    ``compute_dtype="bfloat16"`` (``use_amp``) keeps the factor vectors in
    bf16 for the catalog scorer, with f32 biases and accumulation."""

    net_type: str = "linear"
    n_factors: int = 80
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

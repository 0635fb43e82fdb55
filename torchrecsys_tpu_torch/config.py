"""Configuration dataclasses (port of ``torchrecsys_tpu/config.py:17-208``).

Only the fields the ported slices read are kept. ``TrainConfig`` carries
the fields ``RecSys.fit`` sets plus the epoch knobs of the fused pairwise
and sampled-softmax steps; the kernel is chosen by the device, so the JAX
package's ``pallas_*`` switches have no counterpart.
"""

from __future__ import annotations

import dataclasses
import json
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

    @property
    def num_metadata_features(self) -> int:
        """The number of metadata features (:40-42)."""
        return len(self.metadata_names)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataSchema":
        """Inverse of :meth:`to_dict` (lists back to tuples; :44-50)."""
        d = dict(d)
        for k in ("metadata_names", "metadata_vocab_sizes"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def to_json(self) -> str:
        """The JAX package's ``schema.json`` text, byte for byte (:52-53)."""
        return json.dumps(self.to_dict())


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters the ported slices read (config.py:59-89).

    ``compute_dtype="bfloat16"`` (``use_amp``) keeps the factor vectors in
    bf16 for the catalog scorer, with f32 biases and accumulation, runs the
    fused pairwise step's bf16 variant (bf16-rounded score path, f32
    accumulators) and hands bf16 vectors to the in-batch CE, and runs the
    MLP tower in bf16 (its training forward through the fused layer
    kernels, ops/fused_tower.py). ``hidden_layers`` and ``use_batch_norm``
    shape the MLP (mlp.py:57,75). ``fm_sigmoid`` squashes FM's score
    through the reference's sigmoid (fm.py:99; config.py:77).
    ``neucf_hidden_layers`` are NeuCF's MLP-tower widths (config.py:80).
    ``history_len`` is the sequence models' window of each user's last
    train items, ``sasrec_blocks`` and ``sasrec_heads`` SASRec's encoder
    shape (``n_factors`` divisible by the heads) (config.py:81-87);
    ``hstu_blocks`` and ``hstu_heads`` HSTU's (models/hstu.py; no JAX
    counterpart), whose defaults are HSTU's base setting, SASRec's
    published 2 blocks of 1 head."""

    net_type: str = "linear"
    n_factors: int = 80
    hidden_layers: Tuple[int, ...] = (1024, 128)
    use_batch_norm: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    fm_sigmoid: bool = True
    neucf_hidden_layers: Tuple[int, ...] = (64, 32)
    history_len: int = 20
    sasrec_blocks: int = 2
    sasrec_heads: int = 2
    hstu_blocks: int = 2
    hstu_heads: int = 1


PORTED_LOSSES = ("hinge", "bpr", "logistic", "adaptive_hinge", "warp", "sampled_softmax")
DENSE_OPTIMIZERS = ("adam", "adamw", "adagrad", "sgd")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (config.py:117-208).

    Embedding tables train with rowwise adagrad on the augmented layout
    (``fused_embedding_update``), or with ``embedding_optimizer="sgd"`` /
    ``fused_embedding_update=False`` on the plain tables with a separate
    accumulator (train/optim.py::apply_embedding_updates): the pairwise
    losses through the fused pairwise step (ops/fused_pairwise.py) where
    the model and config fit it and otherwise through the autograd pairwise
    step (MLP: the fused tower kernels under bf16 compute),
    ``loss="sampled_softmax"`` through the autograd step around the
    in-batch CE kernels (ops/softmax_ce.py), with the logQ correction
    (``logq_correction``: subtract log train frequency of each candidate
    column). ``num_negatives`` draws K negatives per positive in training
    (K > 1 takes the autograd step), ``neg_sampling="popularity"`` draws
    them with p(i) ∝ train-count(i)^``popularity_alpha`` (data/sampling.py).
    ``lr_schedule`` (a dict spec or a callable, train/optim.py::
    make_lr_schedule) sets the lr of every step, sparse and dense. Dense
    parameters take ``dense_optimizer`` (train/optim.py, optax's defaults).
    ``drop_remainder=False`` trains the remainder rows in a zero-weighted,
    wrap-around-padded last batch; ``sort_batch_by_user`` orders each
    batch's rows by user id (stable). The first ``profile_epochs`` epochs
    of ``Trainer.fit`` run under torch.profiler (utils/profiling.py)."""

    batch_size: int = 1024
    epochs: int = 1
    learning_rate: float = 1e-2
    lr_schedule: Any = None
    dense_optimizer: str = "adam"  # adam | adamw | adagrad | sgd
    embedding_optimizer: str = "rowwise_adagrad"
    dynamic_neg_sampling: bool = False
    avoid_collisions: bool = True  # in-step negatives never equal the positive
    margin: float = 1.0  # hinge margin
    loss: str = "hinge"
    logq_correction: bool = True
    num_negatives: int = 1
    neg_sampling: str = "uniform"
    popularity_alpha: float = 0.75
    seed: int = 0
    drop_remainder: bool = False
    profile_epochs: int = 0
    fused_embedding_update: bool = True
    sort_batch_by_user: bool = True

    def __post_init__(self) -> None:
        if self.loss not in PORTED_LOSSES:
            raise ValueError(f"unknown loss {self.loss!r}; expected one of {PORTED_LOSSES}")
        if self.loss == "sampled_softmax":  # train/trainer.py:192-203
            if self.num_negatives != 1:
                raise ValueError(
                    "sampled_softmax uses the batch itself as negatives; "
                    "num_negatives must stay 1 (batch_size controls the "
                    "negative count)"
                )
            if self.neg_sampling != "uniform":
                raise ValueError(
                    "neg_sampling is ignored under sampled_softmax (the "
                    "in-batch negative distribution IS the train popularity "
                    "distribution, logQ-corrected); leave it 'uniform'"
                )
        if self.num_negatives < 1:  # train/trainer.py:170-176
            raise ValueError(f"num_negatives must be >= 1, got {self.num_negatives}")
        if self.neg_sampling not in ("uniform", "popularity"):
            raise ValueError(
                f"neg_sampling must be 'uniform' or 'popularity', got {self.neg_sampling!r}"
            )
        if self.embedding_optimizer not in ("rowwise_adagrad", "sgd"):
            raise ValueError(f"unknown embedding optimizer {self.embedding_optimizer!r}")
        if self.dense_optimizer not in DENSE_OPTIMIZERS:
            raise ValueError(f"unknown dense optimizer {self.dense_optimizer!r}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")

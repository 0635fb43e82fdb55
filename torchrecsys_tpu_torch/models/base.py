"""Model base (port of ``torchrecsys_tpu/models/base.py:44-228``).

A model is an ``nn.Module`` that describes its embedding tables
(:class:`TableSpec`), which rows a batch gathers, and the score math from
gathered rows. Its tables live in ``self.tables`` (an ``nn.ParameterDict``
without gradients: serving only); the functional methods take the same
``params = {"tables", "dense"}`` dict as the JAX package, so a caller can
score any set of tables. Dense parameters (the MLP tower) and the model
state (batch-norm running statistics) are plain nested dicts and lists of
tensors in the JAX package's layout.

Batch layout (one "side"):
  user_id:   (B,)      int64
  item_id:   (B,)      int64
  meta_ids:  (B, F, W) int64  (absent when there is no metadata)
  meta_mask: (B, F, W) bool
  hist_ids:  (B, L)    int64  (sequence models: the user's history window)
  hist_mask: (B, L)    bool
  _pair_b:   int              (paired sides only: B, the number of pairs)
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from torchrecsys_tpu_torch.config import DataSchema, ModelConfig

Batch = Dict[str, torch.Tensor]
Params = Dict[str, Any]  # {"tables": {name: (rows, dim)}, "dense": pytree}
State = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TableSpec:
    rows: int
    dim: int
    init: str = "scaled"  # "scaled" = N(0, std=init_scale or 1/dim) | "zero"
    # the std of a table that packs several embeddings side by side
    # (NeuCF's (R, 2d) tables: each half drawn like a d-wide one)
    init_scale: Optional[float] = None


# Table rows are padded to a multiple of this (base.py:55-63); ids address
# only the first ``spec.rows`` rows. Kept so tables carry over from the JAX
# package unchanged.
ROW_ALIGN = 64


def padded_rows(rows: int) -> int:
    return -(-rows // ROW_ALIGN) * ROW_ALIGN


def init_table(
    generator: torch.Generator, spec: TableSpec, dtype: torch.dtype
) -> torch.Tensor:
    """A padded table on the generator's device: zeros, or the reference's
    ScaledEmbedding draw N(0, std=init_scale or 1/dim) (base.py:66-72). The
    draws are not the JAX package's; parity tests carry its tables over
    instead."""
    rows = padded_rows(spec.rows)
    dev = generator.device
    if spec.init == "zero":
        return torch.zeros((rows, spec.dim), dtype=dtype, device=dev)
    draw = torch.randn((rows, spec.dim), generator=generator, device=dev)
    if spec.init_scale is not None:
        return (draw * spec.init_scale).to(dtype)
    return (draw / spec.dim).to(dtype)


def masked_sum(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, W, D) x (B, W) -> (B, D) masked sum over the width axis."""
    return torch.sum(emb * mask[..., None].to(emb.dtype), dim=-2)


def masked_mean(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the width axis (base.py:80-83); a row without ids
    divides by 1."""
    n = torch.clamp_min(torch.sum(mask.to(emb.dtype), dim=-1, keepdim=True), 1.0)
    return masked_sum(emb, mask) / n


def uniform_linear_init(
    generator: torch.Generator, fan_in: int, fan_out: int, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) ``w``
    (fan_in, fan_out) and ``b`` (fan_out,) (base.py:244-253), drawn from
    ``generator`` on its device."""
    bound = 1.0 / (fan_in**0.5)
    dev = generator.device

    def draw(shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return (u * (2.0 * bound) - bound).to(dtype)

    return {"w": draw((fan_in, fan_out)), "b": draw((fan_out,))}


class RecModel(nn.Module, abc.ABC):
    """A pairwise-scoring model."""

    name: str = "base"
    # True on models whose linearized_catalog returns a factorization
    supports_linearized_catalog: bool = False
    # Gather sites (keys of gathers()) whose ids are exactly
    # batch["user_id"]: the pairwise step gathers those rows once per pair,
    # so rowwise adagrad sees one user occurrence with the summed pos + neg
    # gradient (base.py:90-99).
    user_gather_sites: frozenset = frozenset()
    # Fused pairwise step (ops/fused_pairwise.py): side -> (vector table,
    # bias table) packed into one 128-wide row per id, or None when the
    # model's score does not fit the kernel.
    pairwise_pack = None
    # Metadata folds additively into the item vector (composite rows feed
    # the same kernel); FM's per-field math is the other case.
    pairwise_meta: bool = False
    pairwise_fm_fields: bool = False
    # Squash the raw score through a sigmoid before the loss (FM's quirk).
    pairwise_sigmoid: bool = False
    # True on models whose score factorizes as <h_user, v_item> + b_item
    # plus a row constant (pair_vectors): loss="sampled_softmax" needs it.
    supports_sampled_softmax: bool = False
    # True on models that read each user's history window (hist_ids /
    # hist_mask, data/features.py): the sequence models.
    needs_history: bool = False

    def __init__(self, schema: DataSchema, cfg: ModelConfig) -> None:
        super().__init__()
        self.schema = schema
        self.cfg = cfg
        self.param_dtype = DTYPES[cfg.param_dtype]
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.tables = nn.ParameterDict()

    # ---- structure ------------------------------------------------------
    @abc.abstractmethod
    def table_specs(self) -> Dict[str, TableSpec]:
        ...

    def init_dense(self, generator: torch.Generator) -> Any:
        """Fresh dense parameters (none by default)."""
        return {}

    def init_state(self, device: Any = None) -> State:
        """Fresh model state (none by default)."""
        return {}

    @abc.abstractmethod
    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        """Map row-key -> (table name, index tensor) for one batch side."""
        ...

    @abc.abstractmethod
    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        """Gathered rows -> ((B,) f32 scores, state): the new state in train
        mode (batch-norm statistics), else ``state`` itself."""
        ...

    # ---- tables ---------------------------------------------------------
    def init(self, generator: torch.Generator) -> Tuple[Params, State]:
        """Fresh tables, one draw per table in sorted-name order, then the
        dense parameters; and the fresh model state (base.py:138-146)."""
        tables = {
            name: init_table(generator, spec, self.param_dtype)
            for name, spec in sorted(self.table_specs().items())
        }
        dense = self.init_dense(generator)
        return {"tables": tables, "dense": dense}, self.init_state(generator.device)

    def set_tables(self, tables: Mapping[str, torch.Tensor]) -> None:
        """Install ``tables`` as this module's (gradient-free) tables."""
        self.tables = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tables.items()}
        )

    # ---- compute --------------------------------------------------------
    def gather_rows(
        self, tables: Mapping[str, torch.Tensor], batch: Batch
    ) -> Dict[str, torch.Tensor]:
        return {
            key: tables[tname][ids]
            for key, (tname, ids) in self.gathers(batch).items()
        }

    def score(
        self, params: Params, state: State, batch: Batch, train: bool = False
    ) -> Tuple[torch.Tensor, State]:
        rows = self.gather_rows(params["tables"], batch)
        return self.score_rows(params["dense"], state, rows, batch, train)

    def pair_vectors(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, State]:
        """Gathered rows -> ``(h (B, D), v (B, D), vb (B,), state)`` with
        ``score(i, j) = <h_i, v_j> + vb_j`` up to a constant per row, for
        the in-batch softmax (base.py:169-193). Models whose score does not
        factorize raise."""
        raise ValueError(
            f"loss='sampled_softmax' needs a factorizable score "
            f"(RecModel.pair_vectors); net_type={self.name!r} does not factorize"
        )

    def linearized_catalog(self, params: Params, feat):
        """Optional dot-product factorization of the score (base.py:195-211):
        ``(item_vecs (N, D), item_bias (N,), user_fn, transform)`` with
        ``user_fn(params, user_ids) -> (user_vecs, user_const)``, or None."""
        return None

    def _catalog_meta_sums(self, tables: Mapping[str, torch.Tensor], feat) -> list:
        """Per-feature masked sums of metadata embeddings for every item:
        list of (N, D) tensors (base.py:213-228)."""
        out = []
        if not feat or "meta_ids" not in feat or feat["meta_ids"].shape[1] == 0:
            return out
        meta_ids, meta_mask = feat["meta_ids"], feat["meta_mask"]
        for f, fname in enumerate(self.schema.metadata_names):
            emb = tables[f"meta_{fname}"][meta_ids[:, f, :]]
            out.append(masked_sum(emb, meta_mask[:, f, :]))
        return out

    # ---- helpers --------------------------------------------------------
    def _meta_features(self, batch: Batch) -> int:
        m = batch.get("meta_ids")
        return 0 if m is None else int(m.shape[1])

    def _meta_gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        return {
            f"meta:{fname}": (f"meta_{fname}", batch["meta_ids"][:, f, :])
            for f, fname in enumerate(
                self.schema.metadata_names[: self._meta_features(batch)]
            )
        }

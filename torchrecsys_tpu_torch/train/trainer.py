"""The training loop of the fused pairwise step (port of
``torchrecsys_tpu/train/trainer.py``: ``Trainer.__init__`` :142-256,
``_sample_negs`` :259-283, ``_apply_batch_order`` :368-403, the kernel
branch of ``_epoch_fn`` :606-819, ``fit`` :822-869, ``_device_train_data``
:870-891 and the metadata part of ``feature_tables`` :904-928).

The JAX package compiles a whole epoch (shuffle + ``lax.scan`` over
batches). Here an epoch is

1. the epoch builder (:meth:`Trainer.build_epoch`): from six round keys, a
   Feistel permutation of the train split, the zero weights of the
   wrap-around-padded remainder batch (:623-636), one row gather of the
   packed id columns (:637-675), the stable in-batch sort by user and the
   uniform negatives when they are drawn in training
   (``dynamic_neg_sampling``);
2. a Python loop of :func:`~torchrecsys_tpu_torch.ops.fused_pairwise.fused_pairwise_step`
   (or its metadata twin) over the packed ``(rows, 128)`` tables, as the
   scan body ``body_pl`` (:720-790) does. Each step launches the fused
   kernel once; no step syncs with the host: the step losses stay on the
   device and are read once per epoch.

The autograd step ``_step_impl`` (:405-574), evaluation, checkpoints,
meshes, lr schedules and K negatives are still to be ported (ROADMAP.md
§A); a config that needs them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.config import TrainConfig
from torchrecsys_tpu_torch.data.features import Features, feature_tables
from torchrecsys_tpu_torch.data.interactions import InteractionStore
from torchrecsys_tpu_torch.data.sampling import sample_negatives
from torchrecsys_tpu_torch.models.base import RecModel
from torchrecsys_tpu_torch.ops import fused_pairwise as fp
from torchrecsys_tpu_torch.train.optim import (
    augment_tables,
    init_embedding_opt,
    split_augmented,
)
from torchrecsys_tpu_torch.utils.permute import random_permutation, round_keys

log = logging.getLogger("torchrecsys_tpu_torch.train")

TrainState = Dict[str, Any]


@dataclasses.dataclass
class Epoch:
    """One epoch's batches: (nb, b) tensors ``user_id``, ``pos_item_id``,
    ``neg_item_id`` and, when the last batch is padded, ``_w`` (1 for real
    rows, 0 for filler), with each batch's weight sum known on the host."""

    batches: Dict[str, torch.Tensor]
    nb: int
    b: int
    weight_sums: Optional[List[int]] = None


class Trainer:
    """Trains a model with a packed pairwise layout through the fused
    step, on the device of its tables."""

    def __init__(self, model: RecModel, cfg: TrainConfig, device: Any = "cuda") -> None:
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        if model.compute_dtype == torch.bfloat16:
            raise NotImplementedError(
                "training with use_amp=True (bf16 compute) is not ported to "
                "torchrecsys_tpu_torch yet: ROADMAP.md §A item 6 (metadata and "
                "AMP in training)"
            )
        if not fp.pairwise_kernel_applicable(model, cfg):
            raise NotImplementedError(
                f"net_type={model.name!r} with n_factors={model.cfg.n_factors} needs "
                "the autograd train step, which is not ported to "
                "torchrecsys_tpu_torch yet: ROADMAP.md §A item 8 (the autograd step)"
            )
        self._data_cache_key = None
        self._data_cache: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh tables and zero accumulators from a ``torch.Generator``
        seeded with ``cfg.seed``; the generator stays in the state
        (``rng``) and draws every epoch's round keys and negatives."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params, model_state = self.model.init(gen)
        return {
            "tables": params["tables"],
            "dense": params["dense"],
            "model_state": model_state,
            "emb_opt": init_embedding_opt(self.cfg.embedding_optimizer, params["tables"]),
            "step": 0,
            "rng": gen,
        }

    def _rng(self, state: TrainState) -> torch.Generator:
        if state.get("rng") is None:  # a state carried over holds no generator
            state["rng"] = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return state["rng"]

    def _device_train_data(self, store: InteractionStore) -> Dict[str, torch.Tensor]:
        """The train split's columns as int64 on the device, uploaded once
        per store (keyed on the store's process-unique token)."""
        key = (store.token, store.num_train)
        if self._data_cache_key != key:
            self._data_cache = {
                k: torch.as_tensor(np.asarray(v, np.int64), device=self.device)
                for k, v in store.train_arrays().items()
            }
            self._data_cache_key = key
        return self._data_cache

    def feature_tables(self, store: InteractionStore) -> Features:
        """Device-resident item-metadata tables (empty without metadata)."""
        return feature_tables(store, self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _apply_batch_order(batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Reorder every per-row (nb, b) array by ``_order`` (each batch's
        rows sorted by user id, stable). The JAX package reorders inside
        each step; here the whole epoch is reordered at once."""
        order = batches.get("_order")
        if order is None:
            return batches
        return {
            k: torch.gather(v, 1, order) for k, v in batches.items() if k != "_order"
        }

    def build_epoch(
        self, data: Dict[str, torch.Tensor], keys: torch.Tensor, gen: torch.Generator
    ) -> Epoch:
        """The epoch's batches from the Feistel round ``keys``; negatives
        not stored in ``data`` are drawn from ``gen``."""
        n = int(data["user_id"].shape[0])
        if n == 0:
            raise ValueError("fit: the train split is empty")
        b = min(self.cfg.batch_size, n)  # a split smaller than a batch trains as one
        weights = weight_sums = None
        if self.cfg.drop_remainder or n % b == 0:
            nb = n // b
            perm = random_permutation(keys, n)[: nb * b]
        else:
            # remainder rows train too: wrap the permutation around and
            # zero-weight the filler rows
            nb = -(-n // b)
            full = random_permutation(keys, n)
            perm = torch.cat([full, full[: nb * b - n]])
            weights = (torch.arange(nb * b, device=self.device) < n).to(torch.float32)
            weights = weights.reshape(nb, b)
            weight_sums = [b] * (nb - 1) + [n - (nb - 1) * b]
        names = sorted(data)
        shuf = torch.stack([data[k] for k in names], dim=1).index_select(0, perm)
        batches = {k: shuf[:, i].reshape(nb, b) for i, k in enumerate(names)}
        if weights is not None:
            batches["_w"] = weights
        if self.cfg.sort_batch_by_user:
            batches["_order"] = torch.argsort(batches["user_id"], dim=1, stable=True)
            batches = self._apply_batch_order(batches)
        if "neg_item_id" not in batches:
            batches["neg_item_id"] = sample_negatives(
                gen, batches["pos_item_id"], self.model.schema.num_items,
                self.cfg.avoid_collisions,
            )
        return Epoch(batches, nb, b, weight_sums)

    # ------------------------------------------------------------------
    def pack_state(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The epoch layout: user and item sides packed into (rows, 128);
        metadata tables augmented (Rf, D+1) (:693-711)."""
        pack = self.model.pairwise_pack
        aug = augment_tables(state["tables"], state["emb_opt"])
        packed = fp.pack_tables(aug, pack)
        consumed = {name for names in pack.values() for name in names}
        packed.update({k: v for k, v in aug.items() if k not in consumed})
        return packed

    def unpack_state(
        self, state: TrainState, packed: Dict[str, torch.Tensor], steps: int
    ) -> TrainState:
        """Back to (R, D) tables and (R,) accumulators (:793-798)."""
        pack = self.model.pairwise_pack
        aug = fp.unpack_tables(packed, pack, self.model.cfg.n_factors)
        aug.update({k: v for k, v in packed.items() if k not in pack})
        tables, emb_opt = split_augmented(aug)
        return dict(state, tables=tables, emb_opt=emb_opt, step=state["step"] + steps)

    def run_steps(
        self,
        packed: Dict[str, torch.Tensor],
        epoch: Epoch,
        feat: Optional[Features],
        steps: Optional[Sequence[int]] = None,
        updates_fn: Optional[fp.UpdatesFn] = None,
    ) -> torch.Tensor:
        """Run the fused step over ``steps`` (default: every batch of the
        epoch), updating ``packed`` in place. Returns the step losses as a
        device tensor; nothing here syncs with the host."""
        cfg, model = self.cfg, self.model
        d = model.cfg.n_factors
        meta_names = model.schema.metadata_names
        kw = dict(d=d, margin=cfg.margin, loss_kind=cfg.loss, sigmoid=model.pairwise_sigmoid,
                  bf16=False, updates_fn=updates_fn)
        bt = epoch.batches
        losses = []
        for i in range(epoch.nb) if steps is None else steps:
            w = bt["_w"][i] if "_w" in bt else None
            ws = epoch.weight_sums[i] if epoch.weight_sums is not None else None
            ids = (bt["user_id"][i], bt["pos_item_id"][i], bt["neg_item_id"][i])
            if meta_names:
                mvec = [packed[f"meta_{nm}"] for nm in meta_names]
                *_, loss = fp.fused_pairwise_step_meta(
                    packed["user"], packed["item"], mvec,
                    feat["meta_ids"], feat["meta_mask"], *ids, w, cfg.learning_rate,
                    weight_sum=ws, **kw,
                )
            else:
                *_, loss = fp.fused_pairwise_step(
                    packed["user"], packed["item"], *ids, w, cfg.learning_rate,
                    weight_sum=ws, **kw,
                )
            losses.append(loss)
        return torch.stack(losses)

    def train_epoch(
        self,
        state: TrainState,
        data: Dict[str, torch.Tensor],
        feat: Optional[Features],
        keys: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """One epoch; returns the new state and the mean step loss as a
        device scalar. ``keys`` (six Feistel round keys) default to a draw
        from the state's generator; tests pass the JAX package's."""
        gen = self._rng(state)
        if keys is None:
            keys = round_keys(gen)
        epoch = self.build_epoch(data, keys.to(self.device), gen)
        packed = self.pack_state(state)
        losses = self.run_steps(packed, epoch, feat)
        return self.unpack_state(state, packed, epoch.nb), losses.mean()

    def fit(
        self,
        state: TrainState,
        store: InteractionStore,
        epochs: Optional[int] = None,
        verbose: bool = True,
    ) -> Tuple[TrainState, List[float]]:
        """Host loop over epochs (:822-869): per-epoch mean losses. With
        ``verbose`` each epoch's loss is read (one sync per epoch) and
        logged; otherwise all are read at the end."""
        epochs = self.cfg.epochs if epochs is None else epochs
        data = self._device_train_data(store)
        feat = self.feature_tables(store)
        device_losses = []
        out: List[float] = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            state, loss = self.train_epoch(state, data, feat)
            if verbose:
                out.append(float(loss))
                log.info("epoch %d: loss=%.5f (%.2fs)", epoch, out[-1], time.perf_counter() - t0)
            else:
                device_losses.append(loss)
        if not verbose:
            out = [float(x) for x in torch.stack(device_losses).cpu()] if device_losses else []
        return state, out

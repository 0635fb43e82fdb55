"""The training loop and evaluation (port of
``torchrecsys_tpu/train/trainer.py``: ``Trainer.__init__`` :142-256,
``_lr_at`` :232-238, ``_sample_negs`` :259-283, ``_softmax_rows`` :285-318, ``_paired_side``
:321-356, ``_apply_batch_order`` :368-403, ``_step_impl`` :405-574, ``_epoch_fn``
:606-819, ``fit`` :822-869, ``_device_train_data`` :870-891,
``feature_tables`` :904-928, ``_logq_from`` :930-941, ``_eval_fn`` and
``evaluate`` :944-1074, ``fit_streaming`` :893-902).

The JAX package compiles a whole epoch (shuffle + ``lax.scan`` over
batches). Here an epoch is

1. the epoch builder (:meth:`Trainer.build_epoch`): from six round keys, a
   Feistel permutation of the train split, the zero weights of the
   wrap-around-padded remainder batch (:623-636), one row gather of the
   packed id columns (:637-675), the stable in-batch sort by user and, for
   the pairwise losses, the negatives when they are drawn in training
   (``dynamic_neg_sampling``, K > 1 or popularity sampling: ``(nb, b)``,
   or ``(nb, K, b)`` for K draws per row, uniform or from the popularity
   alias table, on the device);
2. a Python loop over the batches. The pairwise losses run
   :func:`~torchrecsys_tpu_torch.ops.fused_pairwise.fused_pairwise_step`
   (or its metadata twin) over the packed ``(rows, 128)`` tables, as the
   scan body ``body_pl`` (:720-790) does: for Linear and FM without
   metadata one call of the step kernel per step (FM with its sigmoid);
   for FM with metadata one launch of the row-level kernel between torch
   gathers and scatters; under ``use_amp`` the bf16 variants. Each step's
   loss is written into one epoch tensor.
   Models and configs the kernel does not take (the MLP, NeuCF, a Linear
   or FM wider than its lanes, K > 1 negatives, ``adaptive_hinge`` and
   ``warp``, the unfused embedding update) run the autograd pairwise step
   (:meth:`Trainer.pairwise_step`) over the augmented ``(R, D+1)`` tables,
   or the plain tables and their separate accumulators
   (``embedding_optimizer="sgd"`` / ``fused_embedding_update=False``): the
   paired side of (1+K)B rows, the model's score (the MLP's bf16 training
   tower through the fused layer kernels, ops/fused_tower.py: one forward
   and one backward launch per hidden layer), ``torch.autograd.grad`` with
   respect to the gathered rows and the dense parameters, the embedding
   update and the dense optimizer.
   ``loss="sampled_softmax"`` runs the autograd step
   (:meth:`Trainer.softmax_step`, ``_step_impl`` with ``fused=True``) over
   the augmented ``(R, D+1)`` tables: gather, ``pair_vectors``, the
   in-batch CE (ops/softmax_ce.py: one forward and one backward kernel
   launch per step), ``torch.autograd.grad`` with respect to the gathered
   rows and one rowwise-adagrad ``index_add_`` per table. No step syncs
   with the host: the step losses stay on the device and are read once per
   epoch. Each step's lr is a host float: ``learning_rate``, or the
   schedule (train/optim.py::make_lr_schedule) at the global step
   ``state["step"] + i``; the dense optimizer reads it at its own count.

:func:`grow_state` (:59-105) carries a state over to a model with larger
vocabularies (``RecSys.update_data``).

On a mesh (``Trainer(..., mesh=make_mesh(...))``, parallel/mesh.py; one
process per rank) every net trains: every rank builds the same global
epoch (the same generator, the same Feistel permutation, the in-batch
sort by user and the in-step negatives of the whole batch), then keeps
its contiguous ``data`` slice of every batch, ``[r b // d, (r + 1) b //
d)`` (a batch that does not divide ``data`` splits unevenly; its loss
normalizer, weight sum and batch-norm row count stay global). Under a
``model`` axis the tables are row shards and every row arrives through
parallel/embedding.py::sharded_lookup. Where the fused pairwise kernel
takes the model and config and the batch divides ``data``, the pairwise
losses run the mesh wrappers of ops/fused_pairwise.py (B1-B4), as the
JAX package's kernel paths do (:684-790). Everything else runs the JAX
package's generic GSPMD step (:405-574) as the autograd steps on this
rank's rows: the rank's share of the global mean loss, the dense
gradients summed over ``data`` in rank order
(parallel/mesh.py::sum_shares_many: every rank the same bits, so the
replicated dense parameters stay bitwise equal), the MLP's batch-norm
statistics over the global batch (``side["_bn_sum"]``, models/mlp.py),
and the embedding row updates all-gathered over ``data`` and scattered
in a fixed order on every replica. Sampled softmax runs the
data-parallel CE (ops/softmax_ce.py::inbatch_softmax_ce_dp, B5; above
128 factors its plain formulation against the all-gathered columns).
Each step's loss is this rank's share; the epoch's are summed over
``data`` once, at its end. Evaluation scores each rank's ``data`` shard
of the test rows and all-reduces the sums.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.config import TrainConfig
from torchrecsys_tpu_torch.data.features import Features, attach_features, feature_tables
from torchrecsys_tpu_torch.data.interactions import InteractionStore
from torchrecsys_tpu_torch.data.sampling import alias_table, sample_negatives, sample_negatives_alias
from torchrecsys_tpu_torch.models.base import Batch, RecModel
from torchrecsys_tpu_torch.ops import fused_pairwise as fp
from torchrecsys_tpu_torch.ops import softmax_ce as sce
from torchrecsys_tpu_torch.parallel.embedding import scatter_add_rows, sharded_lookup, sharded_scatter_add
from torchrecsys_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_gather_many,
    all_reduce_,
    sum_shares,
    sum_shares_many,
)
from torchrecsys_tpu_torch.parallel.sharding import batch_rows, batch_splits, shard_state
from torchrecsys_tpu_torch.train.losses import get_per_row_loss
from torchrecsys_tpu_torch.train.optim import (
    apply_dense_update,
    apply_embedding_updates,
    apply_embedding_updates_fused,
    augment_tables,
    init_dense_opt,
    init_embedding_opt,
    make_lr_schedule,
    split_augmented,
    supports_fused_layout,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from torchrecsys_tpu_torch.utils.logging import get_logger
from torchrecsys_tpu_torch.utils.permute import random_permutation, round_keys
from torchrecsys_tpu_torch.utils.profiling import default_trace_dir, op_summary, trace

log = get_logger("torchrecsys_tpu_torch.train")

TrainState = Dict[str, Any]

def grow_state(state: TrainState, new_model: RecModel, generator: torch.Generator) -> TrainState:
    """``state`` grown to ``new_model``'s vocabularies (:59-105): every
    table keeps its trained leading rows and its rowwise-adagrad
    accumulator bit for bit; the added rows take ``new_model``'s fresh
    init, drawn from ``generator`` (one draw of every table, in the
    model's order), and their accumulators start at zero. A table whose
    padded size did not change is kept as it is. ``dense``,
    ``model_state``, ``dense_opt``, ``step`` and ``rng`` carry over: vocab
    growth changes no dense shape."""
    fresh_params, _ = new_model.init(generator)
    tables = {}
    for name, fresh in fresh_params["tables"].items():
        old = state["tables"].get(name)
        if old is None:
            tables[name] = fresh
        elif old.shape == fresh.shape:
            tables[name] = old
        else:
            fresh[: old.shape[0]] = old
            tables[name] = fresh
    emb_opt = {}
    for name, t in tables.items():
        old_opt = state["emb_opt"].get(name)
        if old_opt is None or "acc" not in old_opt:
            emb_opt[name] = dict(old_opt or {})  # sgd keeps no state
            continue
        acc = old_opt["acc"]
        if acc.shape[0] != t.shape[0]:
            grown = torch.zeros((t.shape[0],), dtype=acc.dtype, device=acc.device)
            grown[: acc.shape[0]] = acc
            acc = grown
        emb_opt[name] = {"acc": acc}
    return dict(state, tables=tables, emb_opt=emb_opt)


def derived_generator(device: Any, seed: int, step: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``: what a state
    restored on another device type than it was saved on draws from (a
    CUDA generator's state cannot be set into a CPU one)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


@dataclasses.dataclass
class Epoch:
    """One epoch's batches: (nb, b) tensors ``user_id``, ``pos_item_id``,
    ``neg_item_id`` (pairwise losses only; (nb, K, b) for K > 1 draws) and,
    when the last batch is padded, ``_w`` (1 for real rows, 0 for filler),
    with each batch's weight sum known on the host. On a mesh the tensors
    hold this rank's ``data`` slice of every batch, ``b`` is the global
    batch and ``rows`` every ``data`` rank's count of its rows."""

    batches: Dict[str, torch.Tensor]
    nb: int
    b: int
    weight_sums: Optional[List[int]] = None
    rows: Optional[List[int]] = None


class Trainer:
    """Trains and evaluates a model on the device of its tables: the
    pairwise losses through the fused pairwise step where the model and
    config fit it, else through the autograd pairwise step; sampled softmax
    through the autograd step around the CE kernels."""

    def __init__(self, model: RecModel, cfg: TrainConfig, device: Any = "cuda", mesh: Optional[Mesh] = None) -> None:
        self.model = model
        self.cfg = cfg
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a torchrecsys_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
            device = mesh.device
        self.mesh = mesh
        self.device = torch.device(device)
        self._softmax = cfg.loss == "sampled_softmax"
        self._fused = False  # the fused pairwise kernel step (else autograd)
        # K > 1, popularity sampling and in-batch softmax drop the stored
        # static negatives (single uniform draws) and draw in training (:219-224)
        self._in_step_negs = cfg.num_negatives > 1 or cfg.neg_sampling != "uniform" or self._softmax
        self.lr_fn = make_lr_schedule(cfg.learning_rate, cfg.lr_schedule)
        if self._softmax:  # :178-191 (num_negatives and neg_sampling: config.py)
            if not model.supports_sampled_softmax:
                raise ValueError(
                    f"loss='sampled_softmax' needs a factorizable score "
                    f"(RecModel.pair_vectors); net_type={model.name!r} does "
                    f"not factorize"
                )
            if model.pairwise_sigmoid:
                raise ValueError(
                    "loss='sampled_softmax' needs the raw score: a model that "
                    "squashes it through a sigmoid saturates the softmax"
                )
            self.per_row_fn = None
        else:
            self._fused = fp.pairwise_kernel_applicable(model, cfg, mesh)
            self.per_row_fn = get_per_row_loss(cfg.loss, model.schema.num_items)
        self._data_cache_key = None
        self._data_cache: Dict[str, torch.Tensor] = {}
        self._alias_key = None
        self._alias: Features = {}

    def _lr_at(self, step: int) -> float:
        """The sparse lr of global step ``step`` (:232-238)."""
        return self.cfg.learning_rate if self.lr_fn is None else self.lr_fn(step)

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh tables, dense parameters and model state, zero accumulators
        and the dense optimizer's state, from a ``torch.Generator`` seeded
        with ``cfg.seed``; the generator stays in the state (``rng``) and
        draws every epoch's round keys and negatives."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params, model_state = self.model.init(gen)
        state = {
            "tables": params["tables"],
            "dense": params["dense"],
            "model_state": model_state,
            "emb_opt": init_embedding_opt(self.cfg.embedding_optimizer, params["tables"]),
            "dense_opt": init_dense_opt(self.cfg.dense_optimizer, params["dense"], self.lr_fn is not None),
            "step": 0,
            "rng": gen,
        }
        if self.mesh is not None:  # every rank drew the whole state; each keeps its piece
            state = shard_state(state, self.mesh)
        return state

    def _rng(self, state: TrainState) -> torch.Generator:
        if state.get("rng") is None:  # a state carried over holds no generator
            state["rng"] = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return state["rng"]

    def _device_train_data(self, store: InteractionStore) -> Dict[str, torch.Tensor]:
        """The train split's columns as int64 on the device, uploaded once
        per store (keyed on the store's process-unique token). A stored
        static negative column is not uploaded when negatives are drawn in
        training (K > 1, popularity, in-batch softmax; :883-888)."""
        key = (store.token, store.num_train)
        if self._data_cache_key != key:
            self._data_cache = {
                k: torch.as_tensor(np.asarray(v, np.int64), device=self.device)
                for k, v in store.train_arrays().items()
                if not (self._in_step_negs and k == "neg_item_id")
            }
            self._data_cache_key = key
        return self._data_cache

    def feature_tables(self, store: InteractionStore) -> Features:
        """Device-resident item-metadata tables (empty without metadata) and,
        for the sequence nets, the users' history windows
        (data/features.py::feature_tables); under popularity sampling
        the alias tables ``neg_prob``, ``neg_alias`` and ``neg_fb``
        (:904-925); under sampled softmax with
        ``logq_correction``, ``logq``: the train split's log item
        frequency."""
        feat = feature_tables(store, self.model, self.device)
        if self.cfg.neg_sampling == "popularity":
            feat.update(self._popularity_tables(store))
        if self._softmax and self.cfg.logq_correction:
            feat["logq"] = self._logq_from(store.train_items)
        return feat

    def _popularity_tables(self, store: InteractionStore) -> Features:
        """The alias tables of the train split's ``count^popularity_alpha``
        on the device, built on the host once per store
        (data/sampling.py::alias_table, the JAX package's tables bit for
        bit)."""
        key = (store.token, store.num_train)
        if self._alias_key != key:
            prob, alias, fb = alias_table(
                store.train_items, self.model.schema.num_items, self.cfg.popularity_alpha
            )
            self._alias = {
                "neg_prob": torch.as_tensor(prob, device=self.device),
                "neg_alias": torch.as_tensor(alias, device=self.device),
                "neg_fb": torch.as_tensor(fb, device=self.device),
            }
            self._alias_key = key
        return self._alias

    def _logq_from(self, items: np.ndarray) -> torch.Tensor:
        """(num_items,) f32 log empirical frequency of ``items``, computed
        in float64 numpy as the JAX package does (bit for bit). Items absent
        from the split never appear as columns of its batches; the 1e-12
        floor only keeps their logs finite."""
        counts = np.bincount(
            np.asarray(items, np.int64), minlength=self.model.schema.num_items
        ).astype(np.float64)
        q = counts / max(counts.sum(), 1.0)
        logq = np.log(np.maximum(q, 1e-12)).astype(np.float32)
        return torch.as_tensor(logq, device=self.device)

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

    def _sample_negs(
        self, gen: torch.Generator, pos: torch.Tensor, feat: Optional[Features], num: Optional[int] = None
    ) -> torch.Tensor:
        """Negatives for the positives ``pos`` (any shape S) drawn from
        ``gen`` (:259-283): shape S for one draw, ``S[:-1] + (K,) + S[-1:]``
        for K draws per row (a (b,) batch gets (K, b), draw-major). Uniform,
        or from the popularity alias tables in ``feat``."""
        num = self.cfg.num_negatives if num is None else num
        tgt = pos if num == 1 else pos.unsqueeze(-2).expand(*pos.shape[:-1], num, pos.shape[-1])
        if self.cfg.neg_sampling == "popularity":
            return sample_negatives_alias(
                gen, tgt, feat["neg_prob"], feat["neg_alias"], feat["neg_fb"], self.cfg.avoid_collisions
            )
        return sample_negatives(gen, tgt, self.model.schema.num_items, self.cfg.avoid_collisions)

    def build_epoch(
        self,
        data: Dict[str, torch.Tensor],
        keys: torch.Tensor,
        gen: torch.Generator,
        feat: Optional[Features] = None,
        negatives: Optional[torch.Tensor] = None,
    ) -> Epoch:
        """The epoch's batches from the Feistel round ``keys``; negatives
        not stored in ``data`` are drawn from ``gen`` (the alias tables in
        ``feat`` under popularity sampling), or taken from ``negatives``
        ((nb, b), or (nb, K, b) for K draws, in the batches' sorted row
        order; a test passes the JAX package's draws)."""
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
        if not self._softmax and "neg_item_id" not in batches:
            if negatives is not None:
                batches["neg_item_id"] = torch.as_tensor(negatives, device=self.device).long()
            else:
                batches["neg_item_id"] = self._sample_negs(gen, batches["pos_item_id"], feat)
        batches, rows = self._rank_rows(batches, b)
        return Epoch(batches, nb, b, weight_sums, rows)

    def _rank_rows(
        self, batches: Dict[str, torch.Tensor], b: int
    ) -> Tuple[Dict[str, torch.Tensor], Optional[List[int]]]:
        """On a mesh, this rank's ``data`` slice of every batch (the whole
        batches are drawn alike on every rank) and every ``data`` rank's
        row count; off a mesh the batches as they are and None."""
        if self.mesh is None:
            return batches, None
        splits = batch_splits(b, self.mesh)
        lo, hi = splits[self.mesh.data_rank]
        return {k: v[..., lo:hi].contiguous() for k, v in batches.items()}, [stop - start for start, stop in splits]

    # ------------------------------------------------------------------
    def pack_state(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The epoch layout: user and item sides packed into (rows, 128);
        metadata tables augmented, (Rf, D+1) and FM's linear-metadata
        tables (Rf, 2) (:693-711)."""
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
        step_fn: Optional[Callable] = None,
        step0: int = 0,
    ) -> torch.Tensor:
        """Run the fused step over ``steps`` (default: every batch of the
        epoch), updating ``packed`` in place: one step call per batch and
        no other op per step, each step's loss written into its slot of
        one ``(len(steps),)`` device tensor, which is returned. Nothing
        here syncs with the host. The rows of the epoch's (nb, b) id
        tensors that ``steps`` spans are split into per-step tensors once
        (``unbind``, cheaper on the host than three views per step).
        ``step_fn`` replaces the step wrapper (the model's
        :func:`fp.fused_pairwise_step` or ``_meta``, with its arguments); a
        check on the card passes the plain step. bf16 compute (``use_amp``)
        runs the steps' bf16 variants (:715); FM with metadata passes its
        linear-metadata tables and ``fm=True`` (:737-750). Batch ``i`` runs at
        the lr of global step ``step0 + i`` (:735)."""
        cfg, model = self.cfg, self.model
        meta_names = model.schema.metadata_names
        steps = range(epoch.nb) if steps is None else steps
        bt = epoch.batches
        losses = torch.empty((len(steps),), dtype=torch.float32, device=bt["user_id"].device)
        if not len(steps):
            return losses
        lo, hi = min(steps), max(steps) + 1
        uids, pids, nids = (
            bt[k][lo:hi].contiguous().unbind(0) for k in ("user_id", "pos_item_id", "neg_item_id")
        )
        ws = bt["_w"][lo:hi].unbind(0) if "_w" in bt else None
        kw = dict(d=model.cfg.n_factors, margin=cfg.margin, loss_kind=cfg.loss,
                  sigmoid=model.pairwise_sigmoid, bf16=model.compute_dtype == torch.bfloat16,
                  loss_out=losses)
        user, item = packed["user"], packed["item"]
        mesh = self.mesh
        if mesh is not None and step_fn is None:
            tp = mesh.shape["model"] > 1
            if meta_names:
                wrapper = fp.fused_pairwise_step_meta_tp if tp else fp.fused_pairwise_step_meta_dp
            else:
                wrapper = fp.fused_pairwise_step_tp if tp else fp.fused_pairwise_step_dp
            step_fn = functools.partial(wrapper, mesh)
        if meta_names:
            step = step_fn or fp.fused_pairwise_step_meta
            lead = (user, item, [packed[f"meta_{nm}"] for nm in meta_names],
                    feat["meta_ids"], feat["meta_mask"])
            if model.pairwise_fm_fields:
                kw.update(meta_lin=[packed[f"linear_meta_{nm}"] for nm in meta_names], fm=True)
        else:
            step = step_fn or fp.fused_pairwise_step
            lead = (user, item)
        for j, i in enumerate(steps):
            r = i - lo
            step(*lead, uids[r], pids[r], nids[r], None if ws is None else ws[r], self._lr_at(step0 + i),
                 weight_sum=None if ws is None else epoch.weight_sums[i], loss_index=j, **kw)
        return self._sum_over_data(losses)

    def _sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """On a mesh, each rank's shares of per-step losses (or sums) added
        over ``data``: one collective for a whole epoch."""
        if self.mesh is None:
            return x
        return all_reduce_(x.contiguous(), self.mesh.data)

    # ------------------------------------------------------------------
    def _softmax_rows(
        self,
        h: torch.Tensor,
        v: torch.Tensor,
        vb: torch.Tensor,
        pos: torch.Tensor,
        logq: Optional[torch.Tensor],
        ce_fns: Optional[sce.CeFns] = None,
        rows: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Per-row in-batch CE (:285-318): the CE kernels when the shape
        allows (``d <= 128``), else the XLA formulation in plain torch. The
        choice is made by shape alone. On a mesh this rank's rows against
        the whole batch's columns (``rows``: every ``data`` rank's row
        count)."""
        mesh = self.mesh if self.mesh is not None and self.mesh.shape["data"] > 1 else None
        if sce.softmax_kernel_applicable(h.shape[0], h.shape[1]):
            vbq = vb.float()
            if logq is not None:
                vbq = vbq - logq[pos]
            if mesh is not None:
                return sce.inbatch_softmax_ce_dp(mesh, h, v, vbq, pos, ce_fns, rows=rows)
            return sce.inbatch_softmax_ce(h, v, vbq, pos, ce_fns)
        if mesh is not None:
            v_g, vb_g, pos_g = (all_gather(t, mesh, "data", rows) for t in (v, vb, pos))
            off = sum(rows[: mesh.data_rank]) if rows is not None else mesh.data_rank * h.shape[0]
            return sce.inbatch_softmax_rows_plain(h, v_g, vb_g, pos, logq, pos_col=pos_g, off=off)
        return sce.inbatch_softmax_rows_plain(h, v, vb, pos, logq)

    def _gather_sites(self, side: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        """``model.gathers(side)``, with the declared user sites checked to
        pass ``side["user_id"]`` through unchanged (:443-480): rowwise
        adagrad sees one user occurrence per row only through them."""
        gmap = self.model.gathers(side)
        uid = side["user_id"]
        declared = self.model.user_gather_sites & set(gmap)
        for k in declared:
            if gmap[k][1] is not uid:
                raise ValueError(
                    f"{self.model.name}.gathers() site {k!r} is declared in "
                    "user_gather_sites but does not pass batch['user_id'] "
                    "through unchanged"
                )
        for k, (_, ids) in gmap.items():
            if k not in declared and ids is uid:
                log.warning(
                    "%s.gathers() site %r passes batch['user_id'] through but is "
                    "not declared in user_gather_sites", self.model.name, k,
                )
        return gmap

    def _take(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of a table: a sharded lookup on a mesh whose
        ``model`` axis splits the tables."""
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            return sharded_lookup(table, ids, self.mesh, "model")
        return table[ids]

    def gather_rows(self, tables: Dict[str, torch.Tensor], side: Batch) -> Dict[str, torch.Tensor]:
        """``model.gather_rows``, through :meth:`_take`."""
        return {k: self._take(tables[t], ids) for k, (t, ids) in self.model.gathers(side).items()}

    def _rows(self, tables: Dict[str, torch.Tensor], gmap, augmented: bool):
        """The gathered rows of each site (``raw``; augmented rows carry the
        accumulator as the last column) and leaf copies of their parameter
        columns to differentiate."""
        raw = {k: self._take(tables[t], ids) for k, (t, ids) in gmap.items()}
        rows = {k: (r[..., :-1] if augmented else r).detach().requires_grad_() for k, r in raw.items()}
        return raw, rows

    def _update_tables(
        self,
        tables: Dict[str, torch.Tensor],
        emb_opt: Optional[Dict[str, Any]],
        gmap,
        raw: Dict[str, torch.Tensor],
        grads: Dict[str, Optional[torch.Tensor]],
        lr: float,
        rows: Optional[Sequence[int]] = None,
    ) -> None:
        """The embedding update of one step, in place: rowwise adagrad on
        the augmented tables (``emb_opt`` None: one ``index_add_`` per
        table, :541-549) or ``embedding_optimizer`` on the plain tables and
        ``emb_opt`` (:550-561). A site without a gradient is skipped. On a
        mesh the sites of every ``data`` rank (``rows``: their row counts)
        are all-gathered and every replica applies the whole batch's in the
        same order."""
        per_table: Dict[str, list] = {}
        for k, g in grads.items():
            if g is not None:
                tname, ids = gmap[k]
                site = (ids, g) if emb_opt is not None else (ids, g, raw[k][..., -1])
                per_table.setdefault(tname, []).append(site)
        if self.mesh is not None:  # the whole batch's sites on every rank, in a fixed order
            sites = [(nm, site) for nm in sorted(per_table) for site in per_table[nm]]
            # each site's ids, gradients and accumulators flattened to one row per occurrence
            flat = [t.reshape((-1,) + t.shape[site[0].dim():]) for _, site in sites for t in site]
            got = iter(all_gather_many(flat, self.mesh, "data", rows))
            per_table = {}
            for nm, site in sites:
                per_table.setdefault(nm, []).append(tuple(next(got) for _ in site))
            if self.mesh.shape["model"] > 1:
                scatter = functools.partial(sharded_scatter_add, mesh=self.mesh, axis="model")
                take = functools.partial(sharded_lookup, mesh=self.mesh, axis="model")
            else:
                scatter, take = scatter_add_rows, None
            if emb_opt is None:
                apply_embedding_updates_fused(lr, tables, per_table, scatter=scatter)
            else:
                apply_embedding_updates(self.cfg.embedding_optimizer, lr, tables, emb_opt, per_table,
                                        scatter=scatter, take=take)
            return
        if emb_opt is None:
            apply_embedding_updates_fused(lr, tables, per_table)
        else:
            apply_embedding_updates(self.cfg.embedding_optimizer, lr, tables, emb_opt, per_table)

    def softmax_step(
        self,
        state: TrainState,
        aug: Dict[str, torch.Tensor],
        user: torch.Tensor,
        pos: torch.Tensor,
        w: Optional[torch.Tensor],
        weight_sum: Optional[float],
        feat: Features,
        ce_fns: Optional[sce.CeFns] = None,
        lr: Optional[float] = None,
        emb_opt: Optional[Dict[str, Any]] = None,
        rows: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """One sampled-softmax step (``_step_impl``, :405-574) on the tables
        ``aug``, updated in place: the augmented tables (``emb_opt`` None),
        or the plain tables with their optimizer state ``emb_opt``. Gather
        the rows, ``pair_vectors``, the per-row CE against the batch's own
        positives, the weighted mean ``sum(per_row * w) / max(sum(w), 1)``
        (the weight sum known on the host), the gradients of the gathered
        rows, one embedding update per table at ``lr`` (default
        ``learning_rate``) and, for a model with dense parameters (the
        sequence encoders), the dense optimizer's step (``state``'s
        ``dense`` and ``dense_opt`` replaced). Returns the loss as a device
        scalar. A site whose rows get no gradient (Linear's user bias: row-constant under
        the softmax) is not scattered: its update would be exactly 0.
        ``ce_fns`` replaces the CE kernels (see ops/softmax_ce.py). On a
        mesh ``rows`` holds every ``data`` rank's row count of the batch
        (default: even) and the loss is this rank's share."""
        side = attach_features({"user_id": user, "item_id": pos}, feat)
        gmap = self._gather_sites(side)
        raw, grows = self._rows(aug, gmap, emb_opt is None)
        leaves, dense = self._dense_leaves(state)
        h, v, vb, _ = self.model.pair_vectors(dense, state["model_state"], grows, side, train=True)
        rows = self._batch_rows(pos.shape[0], rows)
        per_row = self._softmax_rows(h, v, vb, pos, feat.get("logq"), ce_fns, rows)
        loss = self._share(per_row, w, weight_sum, rows)
        keys = list(grows)
        grads = torch.autograd.grad(loss, [grows[k] for k in keys] + leaves, allow_unused=True)
        lr = self.cfg.learning_rate if lr is None else lr
        self._update_tables(aug, emb_opt, gmap, raw, dict(zip(keys, grads)), lr, rows)
        if leaves:  # the sequence encoders; Linear and FM have no dense
            self._dense_step(state, leaves, grads[len(keys):])
        return loss.detach()

    def _batch_rows(self, b_local: int, rows: Optional[Sequence[int]]) -> Optional[List[int]]:
        """Every ``data`` rank's row count of a batch of which this rank
        holds ``b_local`` rows (``rows`` as given, else an even split); None
        off a mesh."""
        if self.mesh is None:
            return None
        return list(rows) if rows is not None else [b_local] * self.mesh.shape["data"]

    def _share(self, per_row: torch.Tensor, w: Optional[torch.Tensor], weight_sum: Optional[float],
               rows: Optional[Sequence[int]]) -> torch.Tensor:
        """The step loss: the weighted mean ``sum(per_row * w) / max(sum(w),
        1)`` (the weight sum of the global batch, known on the host) or the
        mean; on a mesh this rank's share of it (the global row count)."""
        if w is not None:
            return torch.sum(per_row * w) / max(float(weight_sum), 1.0)
        if rows is None or len(rows) == 1:
            return per_row.mean()
        return per_row.sum() / sum(rows)

    @staticmethod
    def _dense_leaves(state: TrainState) -> Tuple[List[torch.Tensor], Any]:
        """Leaf copies of the dense parameters to differentiate, and the
        dense tree of them."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(state["dense"])]
        return leaves, tree_unflatten(state["dense"], leaves)

    def _dense_step(self, state: TrainState, leaves, grads) -> None:
        """The dense optimizer's step on ``state`` (replaced): a leaf
        without a gradient steps with zeros; at the schedule's count under
        an lr schedule. On a mesh each rank's gradient is its share: the
        shares are summed over ``data`` in rank order first."""
        g_dense = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if self.mesh is not None:
            g_dense = sum_shares_many(g_dense, self.mesh, "data")
        state["dense"], state["dense_opt"] = apply_dense_update(
            self.cfg.dense_optimizer, self.cfg.learning_rate, state["dense"],
            tree_unflatten(state["dense"], g_dense), self._dense_opt(state), schedule=self.lr_fn,
        )

    def run_softmax_steps(
        self,
        state: TrainState,
        aug: Dict[str, torch.Tensor],
        epoch: Epoch,
        feat: Features,
        steps: Optional[Sequence[int]] = None,
        ce_fns: Optional[sce.CeFns] = None,
        emb_opt: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """:meth:`softmax_step` over ``steps`` (default: every batch of the
        epoch), updating ``aug`` (and ``emb_opt``) and ``state`` in place,
        batch ``i`` at the lr of global step ``state["step"] + i``; the step
        losses as a device tensor."""
        bt = epoch.batches
        losses = []
        for i in range(epoch.nb) if steps is None else steps:
            w = bt["_w"][i] if "_w" in bt else None
            ws = epoch.weight_sums[i] if epoch.weight_sums is not None else None
            losses.append(self.softmax_step(
                state, aug, bt["user_id"][i], bt["pos_item_id"][i], w, ws, feat, ce_fns,
                lr=self._lr_at(state["step"] + i), emb_opt=emb_opt, rows=epoch.rows,
            ))
        return self._sum_over_data(torch.stack(losses))

    def _paired_side(
        self, user: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, feat: Optional[Features]
    ) -> Batch:
        """The positive and negative halves as ONE side (:321-356): batch-norm
        statistics then cover both alike. ``neg`` is (B,) or (K, B); the side
        holds (1+K)B rows, the positives first, then the K negative blocks in
        draw order. ``side["_pair_b"] = B`` (an int among the tensors) tells
        the sequence nets that every block holds the same B users: they
        encode each pair's history once (models/sequence.py)."""
        reps = 1 + (neg.shape[0] if neg.dim() == 2 else 1)
        side = {"user_id": user.repeat(reps), "item_id": torch.cat([pos, neg.reshape(-1)])}
        side = attach_features(side, feat)
        side["_pair_b"] = user.shape[0]
        return side

    def pairwise_step(
        self,
        state: TrainState,
        aug: Dict[str, torch.Tensor],
        user: torch.Tensor,
        pos: torch.Tensor,
        neg: torch.Tensor,
        w: Optional[torch.Tensor],
        weight_sum: Optional[float],
        feat: Features,
        lr: Optional[float] = None,
        emb_opt: Optional[Dict[str, Any]] = None,
        rows: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """One pairwise step through autograd (``_step_impl``, :405-574) for
        the models and configs the fused pairwise kernel does not take (the
        MLP, NeuCF; Linear or FM wider than the kernel's lanes; K > 1
        negatives, ``adaptive_hinge``, ``warp``; the unfused update): score
        the paired side of (1+K)B rows (``neg`` (B,) or (K, B)), the
        weighted mean ``sum(per_row * w) / max(sum(w), 1)`` (the weight sum
        known on the host), ``torch.autograd.grad`` with respect to the
        gathered rows and the dense parameters, the embedding update of
        :meth:`softmax_step` at ``lr`` on ``aug`` (in place), the dense
        optimizer's step (at the schedule's count under an lr schedule).
        User sites declared in ``user_gather_sites`` gather B rows once and
        repeat them 1+K times inside the loss, so the embedding optimizer
        sees one occurrence with the summed gradient. ``state``'s
        ``dense``, ``dense_opt`` and ``model_state`` (batch-norm running
        statistics) are replaced. Returns the loss as a device scalar. On a
        mesh the step runs on this rank's rows (``rows``: every ``data``
        rank's row count, default even): the loss is its share of the
        global mean and the batch-norm statistics cover the global batch."""
        model, cfg = self.model, self.cfg
        b = pos.shape[0]
        side = self._paired_side(user, pos, neg, feat)
        reps = side["item_id"].shape[0] // b
        rows = self._batch_rows(b, rows)
        if rows is not None and len(rows) > 1:  # statistics over the global batch
            mesh, total = self.mesh, sum(rows)
            side["_bn_sum"] = lambda sums, n: (sum_shares(sums, mesh, "data"), n // b * total)
        gmap = self._gather_sites(side)
        halved = model.user_gather_sites & set(gmap)
        gmap = {k: (t, user if k in halved else ids) for k, (t, ids) in gmap.items()}
        raw, grows = self._rows(aug, gmap, emb_opt is None)
        leaves, dense = self._dense_leaves(state)
        full = {k: torch.cat([v] * reps) if k in halved else v for k, v in grows.items()}
        scores, new_ms = model.score_rows(dense, state["model_state"], full, side, train=True)
        ns = scores[b:]
        if reps > 2:  # K negative blocks -> (K, B) for the loss
            ns = ns.reshape(reps - 1, b)
        per_row = self.per_row_fn(scores[:b], ns, cfg.margin)
        loss = self._share(per_row, w, weight_sum, rows)
        keys = list(grows)
        grads = torch.autograd.grad(loss, [grows[k] for k in keys] + leaves, allow_unused=True)
        lr = cfg.learning_rate if lr is None else lr
        self._update_tables(aug, emb_opt, gmap, raw, dict(zip(keys, grads)), lr, rows)
        self._dense_step(state, leaves, grads[len(keys):])
        state["model_state"] = tree_map(torch.Tensor.detach, new_ms)
        return loss.detach()

    def _dense_opt(self, state: TrainState) -> Dict[str, Any]:
        """The state's dense optimizer state; a state installed without one
        starts from optax's init."""
        if state.get("dense_opt") is None:
            state["dense_opt"] = init_dense_opt(
                self.cfg.dense_optimizer, state["dense"], self.lr_fn is not None
            )
        return state["dense_opt"]

    def run_pairwise_steps(
        self,
        state: TrainState,
        aug: Dict[str, torch.Tensor],
        epoch: Epoch,
        feat: Features,
        steps: Optional[Sequence[int]] = None,
        emb_opt: Optional[Dict[str, Any]] = None,
    ) -> torch.Tensor:
        """:meth:`pairwise_step` over ``steps`` (default: every batch of the
        epoch), updating ``aug`` (and ``emb_opt``) and ``state`` in place,
        batch ``i`` at the lr of global step ``state["step"] + i``; the step
        losses as a device tensor."""
        bt = epoch.batches
        losses = []
        step0 = state["step"]
        for i in range(epoch.nb) if steps is None else steps:
            w = bt["_w"][i] if "_w" in bt else None
            ws = epoch.weight_sums[i] if epoch.weight_sums is not None else None
            losses.append(self.pairwise_step(
                state, aug, bt["user_id"][i], bt["pos_item_id"][i], bt["neg_item_id"][i], w, ws, feat,
                lr=self._lr_at(step0 + i), emb_opt=emb_opt, rows=epoch.rows,
            ))
        return self._sum_over_data(torch.stack(losses))

    def train_epoch(
        self,
        state: TrainState,
        data: Dict[str, torch.Tensor],
        feat: Optional[Features],
        keys: Optional[torch.Tensor] = None,
        negatives: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, torch.Tensor]:
        """One epoch; returns the new state and the mean step loss as a
        device scalar. ``keys`` (six Feistel round keys) default to a draw
        from the state's generator, and the in-training negatives to draws
        from it too; tests pass the JAX package's keys and ``negatives``
        (see :meth:`build_epoch`); :meth:`run_epoch` trains it."""
        gen = self._rng(state)
        if keys is None:
            keys = round_keys(gen)
        epoch = self.build_epoch(data, keys.to(self.device), gen, feat, negatives)
        state, losses = self.run_epoch(state, epoch, feat)
        return state, losses.mean()

    def run_epoch(
        self, state: TrainState, epoch: Epoch, feat: Optional[Features]
    ) -> Tuple[TrainState, torch.Tensor]:
        """Every batch of ``epoch`` through the step this config trains
        with; returns the new state and the step losses as a device tensor.
        The fused pairwise step runs on the packed tables; the autograd
        steps on the augmented tables under rowwise adagrad with
        ``fused_embedding_update`` and f32 tables (:801-819), else on copies
        of the plain tables and their optimizer state."""
        # the mesh wrappers take a batch that divides data; JAX's XLA step the rest (:690-691)
        if self._fused and (self.mesh is None or epoch.b % self.mesh.shape["data"] == 0):
            packed = self.pack_state(state)
            losses = self.run_steps(packed, epoch, feat, step0=state["step"])
            return self.unpack_state(state, packed, epoch.nb), losses
        augmented = self.cfg.fused_embedding_update and supports_fused_layout(
            self.cfg.embedding_optimizer, state["tables"]
        )
        new = dict(state)
        if augmented:
            tables, emb_opt = augment_tables(state["tables"], state["emb_opt"]), None
        else:
            tables = {k: v.clone() for k, v in state["tables"].items()}
            emb_opt = {k: {n: a.clone() for n, a in o.items()} for k, o in state["emb_opt"].items()}
        run = self.run_softmax_steps if self._softmax else self.run_pairwise_steps
        losses = run(new, tables, epoch, feat or {}, emb_opt=emb_opt)
        if augmented:
            tables, emb_opt = split_augmented(tables)
        new.update(tables=tables, emb_opt=emb_opt, step=state["step"] + epoch.nb)
        return new, losses

    def train_step(
        self, state: TrainState, batch: Dict[str, Any], feat: Optional[Features] = None
    ) -> Tuple[TrainState, torch.Tensor]:
        """One batch through the step the epoch runs for this config
        (:358-366); returns the new state (``step`` + 1) and the loss as a
        device scalar. ``batch`` holds (b,) arrays or tensors ``user_id``,
        ``pos_item_id`` and, for a pairwise loss, ``neg_item_id``: the
        static negatives, used unless the config draws its negatives in
        training (:436-439; (K, b) for K draws), else drawn from the
        state's generator; optional ``_w`` (per-row weights) and
        ``_order`` (the row order to apply first). ``feat``: the model's
        :meth:`feature_tables` (needed with metadata or history). On the
        card a Linear/FM pairwise batch is one call of the fused step
        kernel, a softmax batch launches the CE kernels, an MLP batch under
        AMP the tower kernels."""
        bt = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        order = bt.pop("_order", None)
        if order is not None:
            bt = {k: v[..., order.long()] for k, v in bt.items()}
        w = bt.pop("_w", None)
        b = int(bt["pos_item_id"].shape[-1])
        batches = {k: bt[k].long().unsqueeze(0) for k in ("user_id", "pos_item_id", "neg_item_id") if k in bt}
        if self._softmax or self._in_step_negs:
            batches.pop("neg_item_id", None)
        if not self._softmax and "neg_item_id" not in batches:
            batches["neg_item_id"] = self._sample_negs(self._rng(state), batches["pos_item_id"], feat)
        weight_sums = None
        if w is not None:
            batches["_w"] = w.float().unsqueeze(0)
            weight_sums = [float(batches["_w"].sum())]
        batches, rows = self._rank_rows(batches, b)
        state, losses = self.run_epoch(state, Epoch(batches, 1, b, weight_sums, rows), feat)
        return state, losses[0]

    def fit(
        self,
        state: TrainState,
        store: InteractionStore,
        epochs: Optional[int] = None,
        verbose: bool = True,
        profile_dir: Optional[str] = None,
    ) -> Tuple[TrainState, List[float]]:
        """Host loop over epochs (:822-869): per-epoch mean losses. Without
        ``verbose`` or profiling every epoch is dispatched back to back and
        the losses are read once at the end. Otherwise each epoch's loss is
        read at its end (one sync per epoch) and, with ``verbose``, logged;
        each epoch below ``cfg.profile_epochs`` runs inside
        :func:`~torchrecsys_tpu_torch.utils.profiling.trace` into
        ``profile_dir`` (default ``<temp dir>/torchrecsys_tpu_torch_trace``),
        its loss read inside the trace, and after the last of them the
        per-op digest is logged once. Profiling changes no number."""
        epochs = self.cfg.epochs if epochs is None else epochs
        data = self._device_train_data(store)
        feat = self.feature_tables(store)
        if not verbose and self.cfg.profile_epochs <= 0:
            device_losses = []
            for _ in range(epochs):
                state, loss = self.train_epoch(state, data, feat)
                device_losses.append(loss)
            return state, [float(x) for x in torch.stack(device_losses).cpu()] if device_losses else []
        profile_dir = profile_dir or default_trace_dir()
        out: List[float] = []
        for epoch in range(epochs):
            profiling = epoch < self.cfg.profile_epochs
            t0 = time.perf_counter()
            with trace(profile_dir) if profiling else contextlib.nullcontext():
                state, loss = self.train_epoch(state, data, feat)
                out.append(float(loss))  # blocks: the trace holds the whole epoch
            if verbose:
                log.info("epoch %d: loss=%.5f (%.2fs)", epoch, out[-1], time.perf_counter() - t0)
            if profiling and epoch == self.cfg.profile_epochs - 1:
                log.info("per-op device time digest:\n%s", op_summary(profile_dir))
        return state, out

    def fit_streaming(
        self,
        state: TrainState,
        store: InteractionStore,
        superbatch_size: int = 1 << 21,
        epochs: Optional[int] = None,
        seed: int = 0,
        verbose: bool = True,
        keys: Optional[Sequence[torch.Tensor]] = None,
        negatives: Optional[Sequence[Any]] = None,
    ) -> Tuple[TrainState, List[float]]:
        """The double-buffered streaming fit for splits larger than device
        memory (:893-902; train/streaming.py::fit_streaming)."""
        from torchrecsys_tpu_torch.train.streaming import fit_streaming

        return fit_streaming(self, state, store, superbatch_size=superbatch_size, epochs=epochs, seed=seed,
                             verbose=verbose, keys=keys, negatives=negatives)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_sums(
        self,
        state: TrainState,
        batches: Dict[str, torch.Tensor],
        valid: torch.Tensor,
        feat: Features,
    ) -> Dict[str, torch.Tensor]:
        """Mean loss and pairwise AUC over the valid rows of (nb, b)
        batches (:944-1037), accumulated on the device. Sampled softmax:
        the train objective (CE kernel forward) and, for the AUC, one
        negative per row scored on the factorized vectors. Pairwise: the
        model's scores of the positive and the negative blocks (``neg_item_id``
        (nb, b) or (nb, K, b)): the loss over all K draws, the AUC against
        the first."""
        model, cfg = self.model, self.cfg
        params = {"tables": state["tables"], "dense": state["dense"]}
        mstate = state["model_state"]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        tot_n, tot_loss, tot_auc = zero, zero, zero
        for i in range(valid.shape[0]):
            user, pos, neg = (batches[k][i] for k in ("user_id", "pos_item_id", "neg_item_id"))
            b = pos.shape[0]
            if self._softmax:
                side_p = attach_features({"user_id": user, "item_id": pos}, feat)
                rows_p = self.gather_rows(params["tables"], side_p)
                h, vp, vbp, _ = model.pair_vectors(params["dense"], mstate, rows_p, side_p, train=False)
                loss_rows = self._softmax_rows(h, vp, vbp, pos, feat.get("logq"))
                side_n = attach_features({"user_id": user, "item_id": neg}, feat)
                rows_n = self.gather_rows(params["tables"], side_n)
                _, vn, vbn, _ = model.pair_vectors(params["dense"], mstate, rows_n, side_n, train=False)
                ps = (torch.sum(h * vp, dim=-1) + vbp).float()
                ns = (torch.sum(h * vn, dim=-1) + vbn).float()
            else:
                side = self._paired_side(user, pos, neg, feat)
                rows = self.gather_rows(params["tables"], side)
                scores, _ = model.score_rows(params["dense"], mstate, rows, side, train=False)
                ps, ns_all = scores[:b], scores[b:]
                if neg.dim() == 2:  # K draws: the AUC keeps the first
                    ns_all = ns_all.reshape(neg.shape[0], b)
                    ns = ns_all[0]
                else:
                    ns = ns_all
                loss_rows = self.per_row_fn(ps, ns_all, cfg.margin)
            w = valid[i]
            tot_n = tot_n + torch.sum(w)
            tot_loss = tot_loss + torch.sum(loss_rows * w)
            tot_auc = tot_auc + torch.sum((ps > ns).float() * w)
        tot_n, tot_loss, tot_auc = self._sum_over_data(torch.stack([tot_n, tot_loss, tot_auc]))
        n = torch.clamp_min(tot_n, 1.0)
        return {"loss": tot_loss / n, "auc": tot_auc / n}

    def evaluate(
        self,
        state: TrainState,
        store: InteractionStore,
        batch_size: Optional[int] = None,
        verbose: bool = True,
        negatives: Optional[np.ndarray] = None,
    ) -> Dict[str, float]:
        """Loss and pairwise AUC over the test split in ``batch_size``
        batches (:1039-1074); rows past the last full batch ride a
        wrap-around-padded final batch whose filler rows are masked.

        Negatives: the store's static test negatives for a pairwise loss
        when it has them and the config draws none in training, else draws
        from a generator seeded afresh with ``cfg.seed + 0x5EED`` on every
        call, so repeated calls agree (the JAX package folds ``0x5EED + i``
        into its key; its threefry draws cannot be reproduced here): the
        train config's K negatives per row (one under sampled softmax),
        uniform or from the popularity alias tables. ``negatives`` ((n,) or
        (K, n) item rows for the n test rows) replaces them, e.g. with the
        JAX package's draws. Under sampled softmax the logQ correction takes
        the TEST split's item frequency: its candidate columns are test
        positives."""
        if store.num_test == 0:
            if verbose:
                log.info("evaluate: empty test split")
            return {}
        n = store.num_test
        b = min(batch_size or self.cfg.batch_size, n)
        if self.mesh is not None:  # whole batches split over data; the filler rows are masked
            b = -(-b // self.mesh.shape["data"]) * self.mesh.shape["data"]
        nb = -(-n // b)
        pad = nb * b - n

        def batched(arr: np.ndarray) -> torch.Tensor:
            """(..., n) -> (nb, ..., b), the filler rows wrapped around."""
            arr = np.asarray(arr, np.int64)
            if pad:
                arr = np.concatenate([arr, np.resize(arr, arr.shape[:-1] + (pad,))], axis=-1)
            t = torch.as_tensor(arr, device=self.device).reshape(arr.shape[:-1] + (nb, b))
            return t.movedim(-2, 0)

        k = 1 if self._softmax else self.cfg.num_negatives
        arrays = store.test_arrays()
        batches = {key: batched(arrays[key]) for key in ("user_id", "pos_item_id")}
        feat = feature_tables(store, self.model, self.device)
        if self.cfg.neg_sampling == "popularity":
            feat.update(self._popularity_tables(store))
        if negatives is not None:
            want = (n,) if k == 1 else (k, n)
            if np.shape(negatives) != want:
                rows = "one item row" if k == 1 else f"{k} item rows"
                raise ValueError(f"negatives must hold {rows} per test row, {want}")
            batches["neg_item_id"] = batched(negatives)
        elif "neg_item_id" in arrays and not self._in_step_negs:
            batches["neg_item_id"] = batched(arrays["neg_item_id"])
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + 0x5EED)
            batches["neg_item_id"] = self._sample_negs(gen, batches["pos_item_id"], feat, num=k)
        valid = (torch.arange(nb * b, device=self.device) < n).to(torch.float32).reshape(nb, b)
        if self.mesh is not None:  # this rank's columns of every batch
            lo, hi = batch_rows(b, self.mesh)
            batches = {key: v[..., lo:hi].contiguous() for key, v in batches.items()}
            valid = valid[:, lo:hi]
        if self._softmax and self.cfg.logq_correction:
            feat["logq"] = self._logq_from(store.test_items)
        out = self._eval_sums(state, batches, valid, feat)
        result = {k: float(v) for k, v in out.items()}
        if verbose:
            log.info("eval: loss=%.5f auc=%.5f", result["loss"], result["auc"])
        return result

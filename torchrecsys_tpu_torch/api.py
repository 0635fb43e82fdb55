"""User-facing facade ``RecSys`` (port of ``torchrecsys_tpu/api.py``: the
constructor :41-115, ``config`` :118-126, ``_ensure_trainer`` and ``fit``
:128-202, ``predict`` :295-388, ``_patch_short_unseen_rows`` :391-410,
``evaluate`` :205-269, ``_evaluate_ease`` :271-293, ``_filter_seen``
:412-437, ``similar_items`` :439-478, ``item_vectors`` / ``user_vectors``
:481-549,
``_decode_items`` :551-563, ``update_data`` / ``partial_fit`` :566-653
and ``save`` / ``restore`` / ``load`` :655-790).

On a mesh (``mesh=make_mesh(...)``, parallel/mesh.py; one process per
rank, every rank making the same calls) every net fits (train/trainer.py:
the mesh wrappers of ops/fused_pairwise.py where they apply, else the
generic step on this rank's rows), evaluates, predicts (the
model-sharded top-k for the linearizable nets, the ``data``-sharded
generic scorer for the MLP and NeuCF, whose ``exclude_seen`` over-fetches
``top_k + max|seen|`` and filters on the host as JAX's does), streams,
saves and loads; ``self.state`` is this rank's piece (tables row-split
over ``model``). EASE, whose JAX branch never reads the mesh, fits whole
on every rank's device, and world rank 0 writes its checkpoint.

Weights come from :meth:`RecSys.fit` (train/trainer.py: the fused
pairwise step, the autograd pairwise step, e.g. the MLP's and NeuCF's, or
the sampled-softmax step), from a checkpoint (:meth:`RecSys.restore`,
:meth:`RecSys.load`; utils/checkpoint.py), from the JAX package through
:meth:`RecSys.load_jax_tables` (utils/convert.py) or from
:meth:`RecSys.init_tables`. ``self.state`` keeps the JAX shape,
``{"tables", "dense", "model_state", "emb_opt", "dense_opt", "step"}``
(plus the trainer's generator, ``rng``, once fit has run).
:meth:`RecSys.update_data` grows the store and the state with new users
and items (incremental training). ``net_type="ease"`` has no model,
tables or trainer: ``self.ease`` (models/ease.py) holds the interaction
CSR and ``B``, and every EASE branch of the JAX facade is kept here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data.encoder import IdEncoder
from torchrecsys_tpu_torch.data.features import feature_tables
from torchrecsys_tpu_torch.data.interactions import InteractionStore, extend_store, prepare_data
from torchrecsys_tpu_torch.data.metadata import MetadataTable
from torchrecsys_tpu_torch.eval.predict import catalog_topk, ranking_eval, topk_ranking_metrics
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.models.base import padded_rows
from torchrecsys_tpu_torch.models.ease import EASE, topk_rows
from torchrecsys_tpu_torch.ops.dot_topk import dot_topk, pack_seen_mask_torch
from torchrecsys_tpu_torch.parallel.embedding import sharded_lookup
from torchrecsys_tpu_torch.parallel.mesh import Mesh, all_gather
from torchrecsys_tpu_torch.parallel.sharding import gather_state, shard_state
from torchrecsys_tpu_torch.eval.predict import _sharded_catalog_topk, shard_catalog
from torchrecsys_tpu_torch.train.optim import init_dense_opt, init_embedding_opt
from torchrecsys_tpu_torch.train.trainer import Trainer, grow_state
from torchrecsys_tpu_torch.utils.checkpoint import (
    load_aux,
    load_schema,
    pack_store_aux,
    restore_checkpoint,
    save_checkpoint,
)
from torchrecsys_tpu_torch.utils.convert import (
    dense_from_jax,
    emb_opt_from_jax,
    model_state_from_jax,
    tables_from_jax,
)
from torchrecsys_tpu_torch.utils.profiling import annotate, count


def _check_mesh(mesh: Any) -> None:
    """A mesh is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a torchrecsys_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}")


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    return dev


class RecSys:
    """Serving facade over an :class:`InteractionStore` and a model."""

    def __init__(
        self,
        dataset: Any,
        user_id_col: str = "user_id",
        item_id_col: str = "item_id",
        n_factors: int = 80,
        net_type: str = "linear",
        metadata_id_col: Optional[Sequence[str]] = None,
        split_ratio: float = 0.8,
        dynamic_neg_sampling: bool = False,
        use_amp: bool = False,
        use_cuda: bool = False,  # accepted for API parity; ignored
        debug: bool = False,
        path: str = "./",
        hidden_layers: Sequence[int] = (1024, 128),
        use_batch_norm: bool = True,
        mesh: Any = None,
        history_len: int = 20,
        seed: int = 0,
        ease_lam: float = 100.0,
        fm_sigmoid: bool = True,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        """The JAX constructor's keywords, in its order and with its
        defaults, then ``device``. ``fm_sigmoid`` goes to FM's config,
        ``history_len`` (each user's window of train items) to the sequence
        nets' (lstm, sasrec); ``ease_lam`` is EASE's ridge ``lam``
        (``net_type="ease"``: no model, ``self.ease`` instead, api.py:93-104).
        ``debug=True`` writes
        the store's ``config.json`` and ``meta.csv`` to ``path``
        (:meth:`InteractionStore.write_data`). ``mesh`` (a
        :class:`~torchrecsys_tpu_torch.parallel.Mesh`) runs the net on its
        ranks, on the mesh's device; any other object raises
        ``TypeError``."""
        del use_cuda  # the device is `device`
        _check_mesh(mesh)
        self.device = mesh.device if mesh is not None else _resolve_device(device)
        self.seed = seed
        self.debug, self.path, self.mesh = debug, path, mesh
        self.history_len, self.ease_lam, self.fm_sigmoid = history_len, ease_lam, fm_sigmoid
        # the dataset-facing arguments update_data and a checkpoint reuse
        self._user_col, self._item_col, self._split_ratio = user_id_col, item_id_col, split_ratio
        self._n_updates = 0  # update_data calls; each takes its own split seed
        self.dynamic_neg_sampling = dynamic_neg_sampling
        self.model_cfg = ModelConfig(
            net_type=net_type,
            n_factors=n_factors,
            hidden_layers=tuple(hidden_layers),
            use_batch_norm=use_batch_norm,
            compute_dtype="bfloat16" if use_amp else "float32",
            fm_sigmoid=fm_sigmoid,
            history_len=history_len,
        )
        self._bind_store(prepare_data(
            dataset,
            user_id_col=user_id_col,
            item_id_col=item_id_col,
            metadata_id_col=metadata_id_col,
            split_ratio=split_ratio,
            dynamic_neg_sampling=dynamic_neg_sampling,
            seed=seed + 42,
        ))
        self.ease: Optional[EASE] = None
        if net_type == "ease":
            s = self.store.schema
            self.ease = EASE(s.num_users, s.num_items, lam=ease_lam, device=self.device)
        self.trainer: Optional[Trainer] = None
        self.state: Optional[Dict[str, Any]] = None
        if debug:
            self.store.write_data(path)

    def _bind_store(self, store: InteractionStore) -> None:
        """Serve and train ``store``: a model built for its schema, its
        feature tables (the sequence nets' history windows among them), and
        none of the caches of an earlier store: the kept catalog encodes the
        users' histories, so a new store (``update_data``) drops it. EASE
        has neither model nor feature tables."""
        self.store = store
        if self.model_cfg.net_type == "ease":
            self.model, self.feat = None, {}
        else:
            self.model = build_model(store.schema, self.model_cfg).to(self.device)
            self.feat = feature_tables(store, self.model, self.device)
        # kept between calls; rebuilt for a new store, the catalog also
        # when the tables change (_install)
        self._seen_index = None  # (train item rows sorted by user, offsets)
        self._item_vocab = None  # raw item ids, int64 or object
        self._catalog = None  # model.linearized_catalog of the tables

    # ------------------------------------------------------------------
    @property
    def config(self) -> Dict[str, int]:
        """Dataset stats, reference-shaped (dataset.py:199-203)."""
        s = self.store.schema
        return {
            "num_users": s.num_users,
            "num_items": s.num_items,
            "num_metadata": sum(s.metadata_vocab_sizes),
        }

    def _install(self, state: Dict[str, Any]) -> None:
        """Make ``state`` current: its tables become the model's and the
        kept catalog is dropped, so predict serves these tables. On a mesh
        ``state`` is this rank's piece."""
        self.model.set_tables(state["tables"])
        self.state = dict(state, tables=dict(self.model.tables))
        self._catalog = None

    def load_jax_tables(
        self,
        tables: Mapping[str, np.ndarray],
        emb_opt: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
        dense: Any = None,
        model_state: Any = None,
    ) -> None:
        """Serve, or go on training, the JAX package's weights: ``tables``
        is its ``state["tables"]``, ``emb_opt`` its ``state["emb_opt"]``
        (rowwise-adagrad accumulators; None = zeros), ``dense`` its
        ``state["dense"]`` (the MLP tower; None = a fresh seeded draw) and
        ``model_state`` its ``state["model_state"]`` (batch-norm running
        statistics; None = fresh), as numpy arrays (see utils/convert.py)."""
        self._require_tables("load_jax_tables()")
        dev = self.device
        self._install_tables(
            tables_from_jax(tables, self.model, dev), emb_opt,
            None if dense is None else dense_from_jax(dense, self.model, dev),
            None if model_state is None else model_state_from_jax(model_state, self.model, dev),
        )

    def init_tables(self) -> None:
        """Fresh seeded tables and dense parameters (the reference's init;
        draws differ from jax.random's) and zero accumulators."""
        self._require_tables("init_tables()")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params, _ = self.model.init(gen)
        self._install_tables(params["tables"], None, params["dense"])

    def _require_tables(self, what: str) -> None:
        if self.ease is not None:
            raise ValueError(
                f"net_type='ease' has no tables for {what}: its model is the "
                "item-item B matrix, from fit() or a checkpoint"
            )

    def _install_tables(self, tables: Dict[str, torch.Tensor], emb_opt, dense=None,
                        model_state=None) -> None:
        """A fresh training state around ``tables``: ``emb_opt`` as in
        :meth:`load_jax_tables`; ``dense`` and ``model_state`` as given, or
        the model's fresh ones (dense drawn from a generator seeded with
        ``seed``); the dense optimizer's state starts with the first fit;
        step 0. On a mesh each rank keeps its piece."""
        if dense is None:
            dense = self.model.init_dense(torch.Generator(device=self.device).manual_seed(self.seed))
        state = {
            "tables": tables, "dense": dense,
            "model_state": self.model.init_state(self.device) if model_state is None else model_state,
            "emb_opt": emb_opt_from_jax(emb_opt, tables, self.device), "dense_opt": None,
            "step": 0,
        }
        self._install(state if self.mesh is None else shard_state(state, self.mesh))

    # ------------------------------------------------------------------
    def _ensure_trainer(self, train_cfg: TrainConfig) -> Trainer:
        if self.trainer is None or self.trainer.cfg != train_cfg:
            self.trainer = Trainer(self.model, train_cfg, self.device, mesh=self.mesh)
        return self.trainer

    def fit(
        self,
        optimizer: str = "adam",
        epochs: int = 1,
        batch_size: int = 512,
        learning_rate: float = 1e-2,
        profile_epochs: int = 0,
        loss: str = "hinge",
        embedding_optimizer: str = "rowwise_adagrad",
        lr_schedule: Any = None,
        num_negatives: int = 1,
        neg_sampling: str = "uniform",
        verbose: bool = True,
    ) -> List[float]:
        """Train; returns per-epoch mean losses (api.py:145-202).

        ``hinge``/``bpr``/``logistic`` with one negative and rowwise adagrad
        run the fused pairwise step (ops/fused_pairwise.py): on the card,
        one call of the hand-written step kernel per batch (Linear, and FM
        without metadata with its sigmoid), popularity draws and scheduled
        lrs included; FM with metadata runs the row-level kernel once per
        batch around its per-field item-side updates. With ``use_amp`` the
        kernels' bf16 variants run. Models and options that kernel does not
        take (the MLP, NeuCF, ``num_negatives > 1``, ``adaptive_hinge``,
        ``warp``, ``embedding_optimizer="sgd"``) run the autograd pairwise
        step; for the MLP with ``use_amp`` (bf16 compute) and batch norm,
        each step launches the fused tower layer's forward and backward
        kernels once per hidden layer (ops/fused_tower.py), and
        ``optimizer`` trains the dense weights. ``loss="sampled_softmax"``
        trains with in-batch negatives, logQ-corrected: on the card every
        step launches the CE forward and backward kernels (ops/softmax_ce.py)
        once. ``neg_sampling="popularity"`` draws negatives ∝ train
        count^0.75; ``lr_schedule`` (a dict spec or a callable,
        train/optim.py::make_lr_schedule) sets every step's lr, sparse and
        dense. Training starts from the installed tables and accumulators,
        or from fresh seeded ones; afterwards ``predict`` serves the trained
        tables. The first ``profile_epochs`` epochs run under torch.profiler
        and the per-op digest is logged once (``Trainer.fit``).

        ``net_type="ease"`` has no gradient loop: fit() runs the
        closed-form solve on the train split (models/ease.py; the other
        arguments are ignored) and returns ``[]`` (api.py:175-181)."""
        if self.ease is not None:
            self.ease.fit(self.store.train_users, self.store.train_items)
            return []
        train_cfg = TrainConfig(
            batch_size=batch_size,
            epochs=epochs,
            learning_rate=learning_rate,
            lr_schedule=lr_schedule,
            dense_optimizer=optimizer,
            embedding_optimizer=embedding_optimizer,
            dynamic_neg_sampling=self.dynamic_neg_sampling,
            loss=loss,
            num_negatives=num_negatives,
            neg_sampling=neg_sampling,
            seed=self.seed,
            profile_epochs=profile_epochs,
        )
        trainer = self._ensure_trainer(train_cfg)
        state = self.state if self.state is not None else trainer.init_state()
        state, losses = trainer.fit(state, self.store, epochs=epochs, verbose=verbose)
        self._install(state)
        return losses

    def evaluate(
        self,
        batch_size: int = 512,
        eval_metrics: Sequence[str] = ("loss",),
        verbose: bool = True,
    ) -> Dict[str, float]:
        """Test-split evaluation; returns exactly the requested metrics
        (api.py:205-269). ``loss`` and ``auc`` come from the trainer
        (:meth:`Trainer.evaluate`: the train loss and the pairwise win rate
        against one negative per row; under sampled softmax the loss runs
        the CE forward kernel). ``recall@K``, ``precision@K``,
        ``hit_rate@K`` and ``ndcg@K`` come from full-catalog top-k through
        the top-k kernels (eval/predict.py::ranking_eval). Unknown metrics
        raise ``ValueError``; an empty test split gives ``{}``. Tables
        installed without ``fit`` evaluate under the default hinge
        config. ``net_type="ease"`` gives the ranking metrics only
        (:meth:`_evaluate_ease`); ``loss`` or ``auc`` raise ``ValueError``."""
        self._require_fitted("evaluate()")
        if self.store.num_test == 0:
            return {}
        pair_wanted = [m for m in eval_metrics if m in ("loss", "auc")]
        rank_ks: List[int] = []
        for m in eval_metrics:
            if "@" in m:
                kind, _, k_str = m.partition("@")
                if kind not in ("recall", "precision", "hit_rate", "ndcg") or not k_str.isdigit():
                    raise ValueError(f"unknown eval metric {m!r}")
                rank_ks.append(int(k_str))
            elif m not in ("loss", "auc"):
                raise ValueError(f"unknown eval metric {m!r}")
        if self.ease is not None:
            if pair_wanted:
                raise ValueError(
                    "net_type='ease' has no pairwise loss/auc; request "
                    "ranking metrics like 'recall@10' instead"
                )
            return self._evaluate_ease(tuple(sorted(set(rank_ks))), eval_metrics)
        out: Dict[str, float] = {}
        if pair_wanted:
            if self.trainer is None:
                self._ensure_trainer(TrainConfig(
                    dynamic_neg_sampling=self.dynamic_neg_sampling, seed=self.seed,
                ))
            out.update(self.trainer.evaluate(
                self.state, self.store, batch_size=batch_size, verbose=verbose
            ))
        if rank_ks:
            ks: Tuple[int, ...] = tuple(sorted(set(rank_ks)))
            out.update(ranking_eval(
                self.model, self._params(), self.state["model_state"],
                self.store.test_users, self.store.test_items, self.store.schema.num_items,
                self.feat, ks=ks, item_chunk=None, batch_size=batch_size, device=self.device,
                catalog=self._linearized() if self.model.supports_linearized_catalog else None,
                mesh=self.mesh,
            ))
        return {m: out[m] for m in eval_metrics}

    def _evaluate_ease(self, ks: Tuple[int, ...], eval_metrics: Sequence[str]) -> Dict[str, float]:
        """Per-user ranking metrics from EASE's dense scores, 512 test users
        at a time, aggregated as ranking_eval aggregates (api.py:271-293)."""
        num_items = self.store.schema.num_items
        max_k = min(max(ks), num_items)
        uniq, inv = np.unique(np.asarray(self.store.test_users), return_inverse=True)
        parts = [
            topk_rows(self.ease.scores(uniq[s : s + 512]), max_k)[1].cpu().numpy()
            for s in range(0, len(uniq), 512)
        ]
        out = topk_ranking_metrics(
            np.concatenate(parts, axis=0), inv, np.asarray(self.store.test_items), len(uniq), ks, num_items
        )
        return {m: out[m] for m in eval_metrics}

    def _require_fitted(self, what: str) -> None:
        fitted = self.ease.b is not None if self.ease is not None else self.state is not None
        if not fitted:
            raise RuntimeError(
                f"{what} requires model weights -- call fit() or install them "
                "with load_jax_tables() or init_tables()"
            )

    def _params(self) -> Dict[str, Any]:
        return {"tables": self.state["tables"], "dense": self.state["dense"]}

    # ------------------------------------------------------------------
    def _seen(self, rows: np.ndarray) -> List[np.ndarray]:
        """Each user's unique train-split item rows, sorted, from a by-user
        index built once (the JAX facade scans the whole split per user).
        A store without train rows (a cold ``load``) raises ValueError, as
        the JAX facade does (api.py:344-349): it cannot tell what a user
        has seen."""
        if self.store.num_train == 0:
            raise ValueError(
                "predict(exclude_seen=True) needs the train interactions; "
                "this RecSys has none (cold RecSys.load?)"
            )
        if self._seen_index is None:
            count("seen_index.builds")
            tu, ti = self.store.train_users, self.store.train_items
            order = np.argsort(tu, kind="stable")
            offsets = np.searchsorted(
                tu[order], np.arange(self.store.schema.num_users + 1)
            )
            self._seen_index = (ti[order], offsets)
        items, offsets = self._seen_index
        starts, lens = offsets[rows], offsets[rows + 1] - offsets[rows]
        pos = np.repeat(np.arange(len(rows)), lens)
        at = np.arange(lens.sum()) + np.repeat(starts - (np.cumsum(lens) - lens), lens)
        n = self.store.schema.num_items
        keys = np.unique(pos * n + items[at])  # distinct (user, item), sorted
        counts = np.bincount(keys // n, minlength=len(rows))
        return np.split(keys % n, np.cumsum(counts)[:-1])

    def predict(
        self,
        user_id: Union[Any, Sequence[Any]],
        top_k: int = 10,
        prediction_batch_size: int = 4096,
        return_raw_ids: bool = True,
        exclude_seen: bool = False,
        approx_recall: Optional[float] = None,
    ) -> np.ndarray:
        """Full-catalog top-k for one user or a batch of users.

        ``exclude_seen=True`` drops each user's train-split items: a packed
        per-user bitmask rides into the scorer, seen items score as the
        float32 minimum, and the result is exactly the top-k unseen items.
        ``approx_recall`` is accepted and exact (see ops/dot_topk.py).
        EASE scores every item (``X[u] @ B``), fetches ``top_k + max|seen|``
        candidates under ``exclude_seen`` and drops the seen ones on the host
        (api.py:354-366).
        Returns (top_k,) for a scalar user or (U, top_k) for a sequence."""
        with annotate("predict"):
            self._require_fitted("predict()")
            scalar = not isinstance(user_id, (list, tuple, np.ndarray))
            users_raw = [user_id] if scalar else list(user_id)
            with annotate("predict.encode"):
                try:
                    rows = np.asarray(
                        [self.store.user_encoder.encode_one(u) for u in users_raw], np.int64
                    )
                except KeyError as e:
                    raise KeyError(f"predict: unknown user_id -- {e.args[0]}") from None
                users = torch.as_tensor(rows, device=self.device) if self.ease is None else None
            num_items = self.store.schema.num_items
            if self.ease is not None:
                seen = self._seen(rows) if exclude_seen else None
                k_fetch = min(top_k + (max(len(s) for s in seen) if seen else 0), num_items)
                ids = topk_rows(self.ease.scores(rows), k_fetch)[1].cpu().numpy()
                if seen is not None:
                    ids = self._filter_seen(ids, seen, top_k)
                return self._decode_items(ids, return_raw_ids, scalar)
            seen: Optional[List[np.ndarray]] = None
            seen_mask = None
            k_fetch = min(top_k, num_items)
            if exclude_seen:
                with annotate("predict.seen"):
                    seen = self._seen(rows)
                    if self.mesh is not None and not self.model.supports_linearized_catalog:
                        # the generic scorer on a mesh takes no mask (api.py:354-362)
                        k_fetch = min(top_k + max(len(s) for s in seen), num_items)
                    else:
                        pos = np.repeat(np.arange(len(rows)), [len(s) for s in seen])
                        seen_mask = pack_seen_mask_torch(
                            torch.as_tensor(pos, device=self.device),
                            torch.as_tensor(np.concatenate(seen), device=self.device),
                            len(rows),
                            num_items,
                        )
            _, ids = catalog_topk(
                self.model,
                self._params(),
                self.state["model_state"],
                users,
                num_items,
                self.feat,
                top_k=k_fetch,
                chunk_size=prediction_batch_size,
                approx_recall=approx_recall,
                seen_mask=seen_mask,
                catalog=self._linearized() if self.model.supports_linearized_catalog else None,
                mesh=self.mesh,
            )
            with annotate("predict.fetch"):
                ids = ids.cpu().numpy()
            with annotate("predict.decode"):
                if seen_mask is not None:
                    ids = self._patch_short_unseen_rows(ids, seen, num_items)
                elif seen is not None:
                    ids = self._filter_seen(ids, seen, top_k)
                return self._decode_items(ids, return_raw_ids, scalar)

    @staticmethod
    def _patch_short_unseen_rows(
        ids: np.ndarray, seen: List[np.ndarray], num_items: int
    ) -> np.ndarray:
        """Masked items sort after every unseen item, so each row's first
        ``num_items - |seen|`` entries are the top unseen items. A user with
        fewer unseen items than ``top_k`` gets the tail filled with their
        last unseen candidate; a user with nothing unseen is an error."""
        for r, s in enumerate(seen):
            n_unseen = num_items - len(s)
            if n_unseen == 0:
                raise ValueError(
                    "predict(exclude_seen=True): a requested user has "
                    "interacted with the entire catalog -- nothing unseen "
                    "to recommend"
                )
            if n_unseen < ids.shape[1]:
                ids[r, n_unseen:] = ids[r, n_unseen - 1]
        return ids

    @staticmethod
    def _filter_seen(ids: np.ndarray, seen: List[np.ndarray], top_k: int) -> np.ndarray:
        """Drop each row's seen items, keep rank order, truncate to top_k
        (for scorers that over-fetch ``top_k + max(|seen|)`` candidates)."""
        out = np.empty((ids.shape[0], min(top_k, ids.shape[1])), ids.dtype)
        for r, (row, s) in enumerate(zip(ids, seen)):
            keep = row[~np.isin(row, s)]
            if len(keep) == 0:
                raise ValueError(
                    "predict(exclude_seen=True): a requested user has "
                    "interacted with the entire catalog -- nothing unseen "
                    "to recommend"
                )
            if len(keep) < out.shape[1]:
                keep = np.concatenate([keep, np.repeat(keep[-1:], out.shape[1] - len(keep))])
            out[r] = keep[: out.shape[1]]
        return out

    def similar_items(
        self, item_id: Any, top_k: int = 10, return_raw_ids: bool = True
    ) -> np.ndarray:
        """Top-k catalog items by dot product of item factor vectors with
        ``item_id``'s, through the fused kernels (EASE: by its ``B`` row,
        api.py:461-463); the query item itself is excluded."""
        self._require_fitted("similar_items()")
        try:
            row = self.store.item_encoder.encode_one(item_id)
        except KeyError:
            raise KeyError(f"similar_items: unknown item_id -- {item_id!r}") from None
        n = self.store.schema.num_items
        k = min(top_k + 1, n)  # +1: the query item ranks first, drop it
        if self.ease is not None:
            ids = topk_rows(self.ease.b[row][None, :], k)[1].cpu().numpy()
        elif self.mesh is not None:
            ids = self._similar_on_mesh(row, n, k)
        else:
            vecs = self.state["tables"]["item"][:n].float()
            bias = torch.zeros((n,), dtype=torch.float32, device=self.device)
            ids = dot_topk(vecs[row][None, :], vecs, bias, k)[1].cpu().numpy()
        keep = ids[0][ids[0] != row][: min(top_k, n - 1)]
        return self._decode_items(keep[None, :], return_raw_ids, scalar=True)

    def _similar_on_mesh(self, row: int, n: int, k: int) -> np.ndarray:
        """:meth:`similar_items`' scores on a mesh: each ``model`` rank
        scores its item rows against the query row (a sharded lookup), the
        shards' winners merged as B6 merges them."""
        t = self.state["tables"]["item"]
        rows = t.shape[0]
        start = self.mesh.model_rank * rows if self.mesh.shape["model"] > 1 else 0
        n_loc = max(0, min(n - start, rows))
        vecs = torch.zeros((rows, t.shape[1]), dtype=torch.float32, device=self.device)
        vecs[:n_loc] = t[:n_loc].float()
        bias = torch.full((rows,), -torch.inf, dtype=torch.float32, device=self.device)
        bias[:n_loc] = 0.0
        query = torch.tensor([row], device=self.device)
        q = sharded_lookup(t, query, self.mesh, "model").float()
        catalog = (vecs, bias, lambda params, users: (q, torch.zeros((1,), device=self.device)),
                   lambda raw, const: raw, start)
        _, ids = _sharded_catalog_topk(self.model, self._params(), query, n, None, k, self.mesh, catalog=catalog)
        return ids.cpu().numpy()

    # ------------------------------------------------------------------
    def _linearized(self):
        """The model's linearized catalog, kept until the tables change; a
        model whose score does not factorize raises ValueError (api.py:
        482-501)."""
        self._require_fitted("factor-vector export")
        if self.ease is not None:
            raise ValueError(
                "net_type='ease' has no factor vectors (its model is the "
                "item-item B matrix); use predict()/similar_items()"
            )
        if self._catalog is None:
            count("catalog.builds")
            if self.mesh is not None and self.model.supports_linearized_catalog:
                self._catalog = shard_catalog(self.model, self._params(), self.feat, self.mesh)
            else:
                self._catalog = self.model.linearized_catalog(self._params(), self.feat)
        if self._catalog is None:
            raise ValueError(
                f"net_type {self.model_cfg.net_type!r} does not factorize "
                "into user/item vectors (joint-tower scoring); factor "
                "export needs linear/fm/lstm/sasrec"
            )
        return self._catalog

    def item_vectors(self) -> "tuple[np.ndarray, np.ndarray]":
        """``(vecs (num_items, D) f32, bias (num_items,) f32)`` in encoded-row
        order, metadata folded in: index ``[vecs[i], bias[i]]`` and query
        with ``[user_vec, 1.0]`` in an external ANN engine. On a mesh the
        shards' rows are all-gathered over ``model``."""
        item_vecs, item_bias = self._linearized()[:2]
        if self.mesh is not None:
            n = self.store.schema.num_items
            item_vecs = all_gather(item_vecs, self.mesh, "model")[:n]
            item_bias = all_gather(item_bias, self.mesh, "model")[:n]
        return item_vecs.float().cpu().numpy(), item_bias.float().cpu().numpy()

    def user_vectors(
        self, user_id: Optional[Sequence[Any]] = None
    ) -> "tuple[np.ndarray, np.ndarray]":
        """``(vecs (U, D) f32, const (U,) f32)`` for every user (``None``,
        encoded-row order) or for raw ids; ``const`` is the user's
        row-constant score term (Linear's user bias, FM's linear user
        term)."""
        user_fn = self._linearized()[2]
        if user_id is None:
            rows = torch.arange(self.store.schema.num_users, device=self.device)
        else:
            ids = [user_id] if np.ndim(user_id) == 0 else list(user_id)
            try:
                rows = torch.as_tensor(
                    [self.store.user_encoder.encode_one(u) for u in ids],
                    dtype=torch.int64,
                    device=self.device,
                )
            except KeyError as e:
                raise KeyError(f"user_vectors: unknown user_id -- {e}") from None
        vecs, const = user_fn(self._params(), rows)
        return vecs.float().cpu().numpy(), const.float().cpu().numpy()

    def _decode_items(
        self, ids: np.ndarray, return_raw_ids: bool, scalar: bool
    ) -> np.ndarray:
        if return_raw_ids:
            if self._item_vocab is None:
                vocab = self.store.item_encoder.to_list()
                typed = np.asarray(vocab)
                if typed.dtype.kind not in "iu":  # keep the raw objects
                    typed = np.empty(len(vocab), dtype=object)
                    typed[:] = vocab
                self._item_vocab = typed
            out = self._item_vocab[ids]
            if out.dtype == object:
                try:  # collapse to the dtype numpy gives the first row's raw ids
                    out = out.astype(np.asarray(out[0].tolist()).dtype)
                except (ValueError, TypeError):
                    pass
        else:
            out = ids
        return out[0] if scalar else out

    # ------------------------------------------------------------------
    # incremental training (api.py:566-653)
    def update_data(
        self,
        dataset: Any,
        user_id_col: Optional[str] = None,
        item_id_col: Optional[str] = None,
        split_ratio: Optional[float] = None,
    ) -> None:
        """Grow the dataset with new interactions (data/interactions.py::
        extend_store): unseen users and items take new rows at the end,
        the new rows take their own seeded split, and the trained state
        grows (train/trainer.py::grow_state: trained rows and accumulators
        kept bit for bit, new rows freshly drawn from ``seed + 1``). The
        columns and split ratio default to the constructor's. A cold-loaded
        store's frozen encoders thaw for the extension and freeze again
        after. The model, its feature tables, the serving caches and the
        trainer are rebuilt for the grown store. EASE is rebuilt for the
        grown vocabularies, seeded with the interaction CSR it held (a cold
        load's original data merges with the new); until the next ``fit``
        it serves nothing (api.py:617-630). Continue with ``fit``, or use
        :meth:`partial_fit`."""
        encoders = [self.store.user_encoder, self.store.item_encoder, *self.store.metadata.encoders]
        thawed = [e for e in encoders if e.frozen]
        for e in thawed:
            e.thaw()
        try:
            store = extend_store(
                self.store,
                dataset,
                user_id_col or self._user_col,
                item_id_col or self._item_col,
                split_ratio=self._split_ratio if split_ratio is None else split_ratio,
                dynamic_neg_sampling=self.dynamic_neg_sampling,
                seed=self.seed + 43 + self._n_updates,
            )
            self._n_updates += 1
        finally:
            for e in thawed:
                e.freeze()
        self._bind_store(store)
        if self.ease is not None:
            old, s = self.ease, store.schema
            self.ease = EASE(s.num_users, s.num_items, lam=old.lam, device=self.device)
            if old.item_idx is not None:
                self.ease.seed_csr(old.user_ptr, old.item_idx)
            return
        if self.state is not None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
            if self.mesh is None:
                self._install(grow_state(self.state, self.model, gen))
            else:  # grown whole on every rank, then each keeps its piece
                whole = gather_state(self.state, self.mesh)
                self._install(shard_state(grow_state(whole, self.model, gen), self.mesh))
        if self.trainer is not None:  # it holds the old model
            self.trainer = Trainer(self.model, self.trainer.cfg, self.device, mesh=self.mesh)

    def partial_fit(self, dataset: Any, **fit_kwargs) -> List[float]:
        """``update_data(dataset)`` then ``fit(**fit_kwargs)``."""
        self.update_data(dataset)
        return self.fit(**fit_kwargs)

    # ------------------------------------------------------------------
    # checkpoints (api.py:655-790; the format: utils/checkpoint.py)
    def save(self, directory: str) -> None:
        """Write what a cold process needs to ``directory``: the train
        state (``state.pt``), the schema, the raw-id vocabularies, the
        metadata table, the model and train configs and the dataset-facing
        constructor arguments (``aux.pkl``). EASE saves ``{"b"}`` and its
        interaction CSR as ``aux["ease_csr"]`` (api.py:676-685). Read it back
        with :meth:`restore` (same dataset) or :meth:`RecSys.load` (no
        dataset). On a mesh every rank calls it: the state is gathered (EASE's
        ``B`` is whole on every rank) and world rank 0 writes the files a
        single device writes."""
        self._require_fitted("save()")
        aux = pack_store_aux(self.store, self.model_cfg, self.trainer.cfg if self.trainer else None)
        aux["dataset_cols"] = {
            "user": self._user_col,
            "item": self._item_col,
            "split_ratio": self._split_ratio,
            "n_updates": self._n_updates,
        }
        state = self.state
        if self.ease is not None:
            state = {"b": self.ease.b}
            aux["ease_csr"] = {"user_ptr": self.ease.user_ptr, "item_idx": self.ease.item_idx}
        save_checkpoint(directory, state, self.store.schema, aux=aux, mesh=self.mesh)

    def _train_cfg(self, aux: Optional[Dict[str, Any]]) -> TrainConfig:
        """The checkpoint's train config, else this RecSys's trainer's, else
        the default."""
        if aux and aux.get("train_cfg"):
            return TrainConfig(**aux["train_cfg"])
        if self.trainer is not None:
            return self.trainer.cfg
        return TrainConfig(dynamic_neg_sampling=self.dynamic_neg_sampling, seed=self.seed)

    def _target_state(self, cfg: TrainConfig) -> Dict[str, Any]:
        """The layout a checkpoint of this model trained under ``cfg`` must
        have: every table (padded rows, param dtype) and accumulator as a
        tensor on the ``meta`` device, the dense parameters, model state
        and dense optimizer state as the model and ``cfg`` make them."""
        meta = torch.device("meta")
        tables = {
            name: torch.empty((padded_rows(spec.rows), spec.dim), dtype=self.model.param_dtype, device=meta)
            for name, spec in self.model.table_specs().items()
        }
        dense = self.model.init_dense(torch.Generator())
        return {
            "tables": tables,
            "dense": dense,
            "model_state": self.model.init_state("cpu"),
            "emb_opt": init_embedding_opt(cfg.embedding_optimizer, tables),
            "dense_opt": init_dense_opt(cfg.dense_optimizer, dense, cfg.lr_schedule is not None),
            "step": 0,
        }

    def restore(self, directory: str) -> None:
        """Install the train state of ``directory`` (saved for this dataset
        and model). Every table, accumulator, dense parameter and
        optimizer leaf is checked against this model's layout: another
        dataset's or model's checkpoint raises ValueError naming the first
        leaf that differs. EASE reads ``B`` (checked against (I, I) f32) and
        adopts the saved CSR (api.py:692-702)."""
        aux = load_aux(directory)
        if self.ease is not None:
            n = self.store.schema.num_items
            target = {"b": torch.empty((n, n), dtype=torch.float32, device="meta")}
            self.ease.b = restore_checkpoint(directory, target, self.device)["b"]
            if aux and "ease_csr" in aux:
                self.ease.seed_csr(aux["ease_csr"]["user_ptr"], aux["ease_csr"]["item_idx"])
            return
        cfg = self._train_cfg(aux)
        self._install(restore_checkpoint(directory, self._target_state(cfg), self.device, seed=cfg.seed,
                                         mesh=self.mesh))

    @classmethod
    def load(cls, directory: str, mesh: Any = None, device: Union[str, torch.device] = "cuda") -> "RecSys":
        """Rebuild a ``RecSys`` from a checkpoint directory alone (no
        dataset), on ``device``. Raw-id ``predict`` works at once: the
        vocabularies and the metadata table are in the checkpoint, the
        encoders frozen. The splits are not: ``predict(exclude_seen=True)``
        raises, and training goes on after :meth:`update_data` (which
        thaws the encoders for the new ids). The trainer is rebuilt from
        the saved train config, the generator restored (see
        utils/checkpoint.py::restore_checkpoint). EASE comes back with
        ``lam=100``, the default, whatever ``ease_lam`` it was fitted with,
        as JAX's cold load does (api.py:776-784). ``mesh`` re-shards the
        state onto the loading process's mesh (every rank calls it),
        whatever mesh or device saved it; EASE loads whole on every rank."""
        _check_mesh(mesh)  # before anything is read
        aux = load_aux(directory)
        if aux is None:
            raise FileNotFoundError(
                f"{directory} has no aux.pkl; use RecSys(...).restore(directory) "
                "with the original dataset"
            )
        schema = load_schema(directory)
        meta = aux["metadata"]
        metadata = MetadataTable(
            meta["ids"], meta["mask"], tuple(meta["names"]),
            tuple(IdEncoder.from_list(v).freeze() for v in meta["vocabs"]),
        )
        empty = np.zeros((0,), np.int32)
        hist = aux.get("history")
        store = InteractionStore(
            schema=schema,
            user_encoder=IdEncoder.from_list(aux["user_vocab"]).freeze(),
            item_encoder=IdEncoder.from_list(aux["item_vocab"]).freeze(),
            metadata=metadata,
            train_users=empty,
            train_items=empty,
            test_users=empty,
            test_items=empty,
            history_override=(hist["ids"], hist["mask"]) if hist else None,
        )
        model_cfg = ModelConfig(**aux["model_cfg"])
        train_cfg = TrainConfig(**aux["train_cfg"]) if aux["train_cfg"] else TrainConfig()
        cols = aux.get("dataset_cols") or {}
        self = cls.__new__(cls)
        self.device = mesh.device if mesh is not None else _resolve_device(device)
        self.seed = train_cfg.seed
        self.debug, self.path, self.mesh = False, directory, mesh
        self.history_len, self.ease_lam, self.fm_sigmoid = model_cfg.history_len, 100.0, model_cfg.fm_sigmoid
        self._user_col = cols.get("user", "user_id")
        self._item_col = cols.get("item", "item_id")
        self._split_ratio = cols.get("split_ratio", 0.8)
        self._n_updates = cols.get("n_updates", 0)
        self.dynamic_neg_sampling = train_cfg.dynamic_neg_sampling
        self.model_cfg = model_cfg
        self._bind_store(store)
        self.trainer, self.state, self.ease = None, None, None
        if model_cfg.net_type == "ease":
            self.ease = EASE(schema.num_users, schema.num_items, device=self.device)
            self.restore(directory)
            return self
        self.trainer = Trainer(self.model, train_cfg, self.device, mesh=mesh)
        self._install(restore_checkpoint(directory, self._target_state(train_cfg), self.device,
                                         seed=train_cfg.seed, mesh=mesh))
        return self

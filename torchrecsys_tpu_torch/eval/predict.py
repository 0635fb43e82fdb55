"""Batched full-catalog top-k prediction (port of
``torchrecsys_tpu/eval/predict.py``, :37-135 and :248-433).

Dot-factorizable models (``RecModel.linearized_catalog``: Linear) take the
fused score + top-k kernels of ``ops/dot_topk.py``; any model can take the
generic chunked scorer :func:`full_catalog_topk`, plain torch with a
running top-k merge (the MLP's path, its eval tower on running batch-norm
statistics), which is also the fused path's second yardstick.

On a mesh (B6, :144-246) each ``model`` rank scores only the catalog rows
of its item-table shard (:func:`shard_catalog`): its item rows and biases
where they lie, the metadata tables all-gathered over ``model`` (vocabulary
rows, not catalog rows), the padded rows at a -inf bias, the seen mask
re-packed for the shard's items. The (U, k_local) winners of every shard
are all-gathered over ``model`` and merged in (value desc, index asc)
order, ``lax.top_k``'s over shard-ordered candidates, so ids and values
are the single-device call's bit for bit. The sequence nets' user
vectors encode history rows read through the sharded lookup.

The generic scorer on a mesh (:311-326; the MLP, NeuCF) pads the users to
a multiple of ``data``; each ``data`` rank scores its slice of them
against the whole catalog, and the lists are all-gathered over ``data``,
the padding dropped. Where ``model`` splits the tables, each ``model``
rank scores the catalog rows of its item-table shard where they lie (the
users' rows by one sharded lookup, the metadata vocabularies
all-gathered) and the shards' lists merge as B6's do: JAX reads every
item row of every chunk through the sharded lookup instead, one
collective of the whole cross product's rows per chunk.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import Mapping

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchrecsys_tpu_torch.data.features import Features, attach_features
from torchrecsys_tpu_torch.models.base import Params, RecModel, State
from torchrecsys_tpu_torch.ops.dot_topk import _MASK_TILE, _round_up, dot_topk, mask_bits_for_items
from torchrecsys_tpu_torch.parallel.embedding import sharded_lookup
from torchrecsys_tpu_torch.parallel.mesh import all_gather, all_gather_many
from torchrecsys_tpu_torch.parallel.sharding import batch_rows


def _score_chunk(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,  # (U,)
    item_ids: torch.Tensor,  # (C,)
    feat: Optional[Features],
) -> torch.Tensor:
    """Score the (U x C) user-item cross product -> (U, C)."""
    u, c = user_ids.shape[0], item_ids.shape[0]
    side = {
        "user_id": user_ids.repeat_interleave(c),
        "item_id": item_ids.repeat(u),
    }
    side = attach_features(side, feat)
    scores, _ = model.score(params, state, side, train=False)
    return scores.reshape(u, c)


def full_catalog_scores(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features] = None,
) -> torch.Tensor:
    """The dense (U, num_items) score matrix (for recall@k-style metrics;
    :436-452): :func:`_score_chunk` over the whole catalog."""
    device = next(iter(params["tables"].values())).device
    user_ids = torch.as_tensor(user_ids, device=device).long()
    items = torch.arange(num_items, dtype=torch.int64, device=device)
    return _score_chunk(model, params, state, user_ids, items, feat)


def full_catalog_topk(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,  # (U,)
    num_items: int,
    feat: Optional[Features] = None,
    top_k: int = 10,
    chunk_size: int = 4096,
    seen_mask: Optional[torch.Tensor] = None,  # ops.dot_topk.pack_seen_mask
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic chunked top-k, for every model (predict.py:57-110).

    Returns (scores (U, k), item rows (U, k)) descending. Each chunk's
    scores join the running top-k and a stable descending sort keeps the
    first k, so ties go to the lower item row, as ``lax.top_k`` does. Seen
    items score -inf. The running list starts as k (-inf, row 0) entries,
    as in the JAX scan, so a user with fewer than k unseen items gets row-0
    fillers there too."""
    dev = user_ids.device
    k = min(top_k, num_items)
    u = user_ids.shape[0]
    top_v = torch.full((u, k), -torch.inf, dtype=torch.float32, device=dev)
    top_i = torch.zeros((u, k), dtype=torch.int64, device=dev)
    for s in range(0, num_items, chunk_size):
        items = torch.arange(s, min(num_items, s + chunk_size), device=dev)
        sc = _score_chunk(model, params, state, user_ids, items, feat)
        if seen_mask is not None:
            sc = torch.where(mask_bits_for_items(seen_mask, items), -torch.inf, sc)
        cat_v = torch.cat([top_v, sc], dim=1)
        cat_i = torch.cat([top_i, items[None, :].expand(u, -1)], dim=1)
        v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
        top_v = v[:, :k]
        top_i = torch.gather(cat_i, 1, pos[:, :k])
    return top_v, top_i.to(torch.int32)


def _fused_catalog_topk(
    model: RecModel,
    params: Params,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features],
    top_k: int,
    approx_recall: Optional[float] = None,
    seen_mask: Optional[torch.Tensor] = None,
    catalog=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linearized catalog through the fused kernels (predict.py:116-135).
    ``catalog`` is ``model.linearized_catalog(params, feat)`` when the
    caller keeps it between calls."""
    if catalog is None:
        catalog = model.linearized_catalog(params, feat)
    item_vecs, item_bias, user_fn, transform = catalog
    user_vecs, user_const = user_fn(params, user_ids)
    raw, ids = dot_topk(
        user_vecs, item_vecs, item_bias, min(top_k, num_items),
        approx_recall=approx_recall, seen_mask=seen_mask,
    )
    return transform(raw, user_const), ids


class _ShardedRows:
    """A table row-sharded over ``model`` read as ``table[ids]``: a sharded
    lookup of the distinct ids (a scorer's cross product repeats each user
    and item row many times; the all-reduce carries each row once)."""

    def __init__(self, table, mesh):
        self._table, self._mesh = table, mesh

    def __getitem__(self, ids):
        if self._mesh.shape["model"] == 1:
            return self._table[ids]
        uniq, inv = torch.unique(ids, return_inverse=True)
        return sharded_lookup(self._table, uniq, self._mesh, "model")[inv]


class _ShardedTables(Mapping):
    """Row-sharded tables as a model's scorers and a linearized catalog's
    ``user_fn`` index them, ``tables[name][ids]``, every lookup a sharded
    one."""

    def __init__(self, tables, mesh):
        self._tables, self._mesh = tables, mesh

    def __getitem__(self, name):
        return _ShardedRows(self._tables[name], self._mesh)

    def __iter__(self):
        return iter(self._tables)

    def __len__(self):
        return len(self._tables)


def _sharded_params(params: Params, mesh) -> Params:
    return {"tables": _ShardedTables(params["tables"], mesh), "dense": params.get("dense")}


def shard_catalog(model: RecModel, params: Params, feat: Optional[Features], mesh):
    """This ``model`` rank's part of the linearized catalog: ``(item_vecs
    (R, D), item_bias (R,), user_fn, transform, start)`` for the R rows
    ``[start, start + R)`` of its item-table shard, rows past the catalog
    at a -inf bias so they never win. ``user_fn`` takes the user ids and
    looks their rows up over ``model``."""
    tables = params["tables"]
    rows = tables["item"].shape[0]
    start = mesh.model_rank * rows
    n = model.schema.num_items
    n_loc = max(0, min(n - start, rows))
    view = dict(tables)
    if mesh.shape["model"] > 1:  # the metadata vocabularies whole on every rank
        for name in tables:
            if name.startswith(("meta_", "linear_meta_")):
                view[name] = all_gather(tables[name], mesh, "model")
    local = copy.copy(model)
    local.schema = dataclasses.replace(model.schema, num_items=n_loc)
    sub = feat  # the sequence nets' history windows: by user, whole on every rank
    if feat and "meta_ids" in feat:
        sub = dict(feat, meta_ids=feat["meta_ids"][start : start + n_loc],
                   meta_mask=feat["meta_mask"][start : start + n_loc])
    q, bias, user_fn, transform = local.linearized_catalog({"tables": view, "dense": params.get("dense")}, sub)
    item_vecs = torch.zeros((rows, q.shape[1]), dtype=q.dtype, device=q.device)
    item_vecs[:n_loc] = q
    item_bias = torch.full((rows,), -torch.inf, dtype=torch.float32, device=q.device)
    item_bias[:n_loc] = bias

    def sharded_user_fn(params_, user_ids):
        return user_fn(_sharded_params(params_, mesh), user_ids)

    return item_vecs, item_bias, sharded_user_fn, transform, start


def _shard_mask(seen_mask: torch.Tensor, start: int, n_loc: int, rows: int) -> torch.Tensor:
    """The packed seen mask of items ``[start, start + n_loc)`` as a mask of
    an ``rows``-item catalog of its own (ops/dot_topk.py's layout)."""
    dev = seen_mask.device
    items = torch.arange(n_loc, device=dev)
    bits = mask_bits_for_items(seen_mask, items + start).to(torch.int32)  # (U, n_loc)
    w = _MASK_TILE // 32
    j = items % _MASK_TILE
    word = (items // _MASK_TILE) * w + (j % w)
    bit = (j // w).to(torch.int32)
    val = torch.where(bit == 31, torch.iinfo(torch.int32).min, torch.ones_like(bit) << bit.clamp(max=30))
    out = torch.zeros((seen_mask.shape[0], _round_up(max(rows, 1), _MASK_TILE) // 32), dtype=torch.int32,
                      device=dev)
    out.index_add_(1, word, bits * val[None, :])  # one bit per item: the sum is the OR
    return out


def _sharded_catalog_topk(
    model: RecModel,
    params: Params,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features],
    top_k: int,
    mesh,
    seen_mask: Optional[torch.Tensor] = None,
    catalog=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 (:144-246): this rank's catalog shard through the fused kernels
    with ``k_local = min(k, shard rows)``, the (U, k_local) winners of every
    shard all-gathered over ``model`` and merged. ``catalog`` is a kept
    :func:`shard_catalog`."""
    item_vecs, item_bias, user_fn, transform, start = catalog or shard_catalog(model, params, feat, mesh)
    rows = item_vecs.shape[0]
    user_vecs, user_const = user_fn(params, user_ids)
    k = min(top_k, num_items)
    mask = None
    if seen_mask is not None:
        mask = _shard_mask(seen_mask, start, max(0, min(num_items - start, rows)), rows)
    vals, ids = dot_topk(user_vecs, item_vecs, item_bias, min(k, rows), seen_mask=mask)
    raw, ids = _merge_shards(vals, ids.to(torch.int64) + start, k, mesh)
    return transform(raw, user_const), ids.to(torch.int32)


def _merge_shards(vals: torch.Tensor, ids: torch.Tensor, k: int, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every ``model`` shard's (U, k_local) winners all-gathered and merged
    in (value desc, index asc) order: the stable sort keeps shard order,
    which is index order, among ties."""
    m = mesh.shape["model"]
    if m > 1:
        u, kl = vals.shape
        vals, ids = (x.reshape(m, u, kl).permute(1, 0, 2).reshape(u, m * kl)
                     for x in all_gather_many([vals, ids], mesh, "model"))
    vals, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(ids, 1, pos[:, :k])


def _item_shard_topk(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features],
    top_k: int,
    chunk_size: int,
    mesh,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`full_catalog_topk` of ``user_ids`` over the catalog rows of
    this ``model`` rank's item-table shard, merged over ``model``: the
    users' rows by one sharded lookup, the item rows where they lie, every
    other table (the metadata vocabularies) all-gathered."""
    tables = params["tables"]
    rows = tables["item"].shape[0]
    start = mesh.model_rank * rows
    n_loc = max(0, min(num_items - start, rows))
    view = {name: all_gather(t, mesh, "model") for name, t in tables.items() if name not in ("user", "item")}
    view["user"] = sharded_lookup(tables["user"], user_ids, mesh, "model")
    view["item"] = tables["item"]
    sub = feat
    if feat and "meta_ids" in feat:
        sub = dict(feat, meta_ids=feat["meta_ids"][start : start + n_loc],
                   meta_mask=feat["meta_mask"][start : start + n_loc])
    mask = None if seen_mask is None else _shard_mask(seen_mask, start, n_loc, rows)
    positions = torch.arange(user_ids.shape[0], device=user_ids.device)
    vals, ids = full_catalog_topk(model, {"tables": view, "dense": params.get("dense")}, state, positions, n_loc,
                                  sub, top_k=top_k, chunk_size=chunk_size, seen_mask=mask)
    ids = ids.to(torch.int64)
    fill = min(top_k, rows) - vals.shape[1]  # every shard's list as long (the catalog's last shard is short)
    if fill > 0:  # -inf at rows past the catalog: they sort after every item
        vals = torch.cat([vals, vals.new_full((vals.shape[0], fill), -torch.inf)], dim=1)
        ids = torch.cat([ids, (n_loc + torch.arange(fill, device=ids.device)).expand(ids.shape[0], -1)], dim=1)
    return _merge_shards(vals, ids + start, min(top_k, num_items), mesh)


def _data_sharded_topk(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features],
    top_k: int,
    chunk_size: int,
    mesh,
    seen_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generic scorer on a mesh (:311-326): the users padded to a
    multiple of ``data`` (with row 0), this rank's contiguous slice of
    them scored against the whole catalog (:func:`full_catalog_topk`; on
    a row-sharded ``model`` axis shard by shard, :func:`_item_shard_topk`),
    the (U, k) lists all-gathered over ``data`` and the padding dropped. A
    ``seen_mask`` (U rows) is sliced with the users."""
    u = user_ids.shape[0]
    pad = (-u) % mesh.shape["data"]
    users = torch.cat([user_ids, user_ids.new_zeros((pad,))])
    lo, hi = batch_rows(users.shape[0], mesh)
    mask = None
    if seen_mask is not None:
        mask = torch.cat([seen_mask, seen_mask.new_zeros((pad, seen_mask.shape[1]))])[lo:hi]
    score = _item_shard_topk if mesh.shape["model"] > 1 else full_catalog_topk
    kw = {"mesh": mesh} if mesh.shape["model"] > 1 else {}
    vals, ids = score(model, params, state, users[lo:hi], num_items, feat, top_k=top_k, chunk_size=chunk_size,
                      seen_mask=mask, **kw)
    vals, ids = all_gather_many([vals, ids.to(torch.int32)], mesh, "data")
    return vals[:u], ids[:u]


def catalog_topk(
    model: RecModel,
    params: Params,
    state: State,
    user_ids: torch.Tensor,
    num_items: int,
    feat: Optional[Features] = None,
    top_k: int = 10,
    chunk_size: int = 4096,
    use_fused: bool = True,
    approx_recall: Optional[float] = None,
    seen_mask: Optional[torch.Tensor] = None,
    catalog=None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-catalog top-k with kernel dispatch (predict.py:248-335):
    linearizable models take the fused kernels, on a ``mesh`` the
    model-sharded B6 (:func:`_sharded_catalog_topk`); everything else the
    generic chunked scorer, on a ``mesh`` sharded over ``data``
    (:func:`_data_sharded_topk`). ``approx_recall`` is exact in the port (see
    ``ops.dot_topk.dot_topk``) and, as in JAX, refused off the fused path.
    ``catalog`` optionally passes a kept ``model.linearized_catalog`` (on a
    mesh, :func:`shard_catalog`) to the fused path (the facade keeps it
    between table installs)."""
    if mesh is not None and use_fused and model.supports_linearized_catalog:
        return _sharded_catalog_topk(model, params, user_ids, num_items, feat, top_k, mesh,
                                     seen_mask=seen_mask, catalog=catalog)
    if use_fused and model.supports_linearized_catalog:
        return _fused_catalog_topk(
            model, params, user_ids, num_items, feat, top_k,
            approx_recall=approx_recall, seen_mask=seen_mask, catalog=catalog,
        )
    if approx_recall is not None:
        raise ValueError(
            f"approx_recall is only supported for models with a dot-product "
            f"catalog factorization (linearized_catalog); "
            f"{type(model).__name__} scores the catalog through the generic "
            f"chunked path, which is always exact -- drop approx_recall"
        )
    if mesh is not None:
        return _data_sharded_topk(model, params, state, user_ids, num_items, feat, top_k, chunk_size, mesh,
                                  seen_mask)
    return full_catalog_topk(
        model, params, state, user_ids, num_items, feat,
        top_k=top_k, chunk_size=chunk_size, seen_mask=seen_mask,
    )


def ranking_eval(
    model: RecModel,
    params: Params,
    state: State,
    test_users: np.ndarray,  # (n_test,) encoded rows
    test_items: np.ndarray,  # (n_test,) encoded rows
    num_items: int,
    feat: Optional[Features] = None,
    ks: Tuple[int, ...] = (10,),
    user_chunk: int = 512,
    item_chunk: Optional[int] = 4096,
    batch_size: Optional[int] = None,
    device: Optional[torch.device] = None,
    catalog=None,
    mesh=None,
) -> Dict[str, float]:
    """Per-user recall/precision/hit_rate/ndcg@k over a test split
    (predict.py:338-389): top-k ids from :func:`catalog_topk` (on a
    ``mesh`` through B6; every rank gets the same ids), aggregated
    host-side by :func:`topk_ranking_metrics`. Items are not filtered by
    train-set membership, matching the reference. ``catalog`` as in
    :func:`catalog_topk`."""
    if item_chunk is None:
        item_chunk = batch_size or 4096
    max_k = min(max(ks), num_items)
    uniq, inv = np.unique(np.asarray(test_users), return_inverse=True)
    parts = []
    for s in range(0, len(uniq), user_chunk):
        chunk = torch.as_tensor(uniq[s : s + user_chunk], device=device).long()
        _, ids = catalog_topk(
            model, params, state, chunk, num_items, feat,
            top_k=max_k, chunk_size=item_chunk, catalog=catalog, mesh=mesh,
        )
        parts.append(ids.cpu().numpy())
    topk = np.concatenate(parts, axis=0)
    return topk_ranking_metrics(
        topk, inv, np.asarray(test_items), len(uniq), ks, num_items
    )


def topk_ranking_metrics(
    topk: np.ndarray,  # (n_uniq, max_k) item ids, descending score
    inv: np.ndarray,  # (n_test,) test row -> uniq-user index
    test_items: np.ndarray,  # (n_test,)
    n_uniq: int,
    ks: Tuple[int, ...],
    num_items: int,
) -> Dict[str, float]:
    """Host-side per-user aggregation (predict.py:392-433). NDCG counts
    distinct (user, item) pairs; recall/precision/hit_rate count rows."""
    member = topk[inv] == test_items[:, None]  # (n_test, max_k)
    n_rows_per_user = np.bincount(inv, minlength=n_uniq).astype(np.float64)
    disc = 1.0 / np.log2(np.arange(topk.shape[1]) + 2.0)
    pair_key = inv.astype(np.int64) * (num_items + 1) + test_items.astype(np.int64)
    _, first_idx = np.unique(pair_key, return_index=True)
    dedup = np.zeros(len(inv), bool)
    dedup[first_idx] = True
    inv_d = inv[dedup]
    n_distinct = np.bincount(inv_d, minlength=n_uniq).astype(np.int64)
    out: Dict[str, float] = {}
    for k in ks:
        kk = min(k, num_items)
        hit_row = member[:, :kk].any(axis=1)
        hits_per_user = np.bincount(inv, weights=hit_row, minlength=n_uniq)
        out[f"recall@{k}"] = float(np.mean(hits_per_user / n_rows_per_user))
        out[f"precision@{k}"] = float(np.mean(hits_per_user / kk))
        out[f"hit_rate@{k}"] = float(np.mean(hits_per_user > 0))
        gain_row = (member[dedup][:, :kk] * disc[:kk]).sum(axis=1)
        dcg = np.bincount(inv_d, weights=gain_row, minlength=n_uniq)
        ideal_cum = np.concatenate([[0.0], np.cumsum(disc[:kk])])
        idcg = ideal_cum[np.minimum(n_distinct, kk)]
        out[f"ndcg@{k}"] = float(np.mean(dcg / np.maximum(idcg, 1e-12)))
    return out

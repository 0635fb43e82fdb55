"""Encoded interaction store (port of
``torchrecsys_tpu/data/interactions.py``: the store :26-80 and :110-172,
``prepare_data`` :175-256, ``extend_store`` :259-398).

The store is host-side numpy: encoded int32 user/item rows per split, the
static negatives, the item metadata table and the schema. Serving reads
the encoders, the schema, the metadata and the train split (for
``exclude_seen``); training reads :meth:`InteractionStore.train_arrays`.
:func:`extend_store` grows a store with new interactions (incremental
training, ``RecSys.update_data``).
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from torchrecsys_tpu_torch.config import DataSchema
from torchrecsys_tpu_torch.data.encoder import IdEncoder, encode_column
from torchrecsys_tpu_torch.data.metadata import MetadataTable
from torchrecsys_tpu_torch.data.sampling import sample_negatives_np


@dataclasses.dataclass
class InteractionStore:
    """Encoded interactions + metadata + schema for one dataset."""

    schema: DataSchema
    user_encoder: IdEncoder
    item_encoder: IdEncoder
    metadata: MetadataTable
    train_users: np.ndarray
    train_items: np.ndarray
    test_users: np.ndarray
    test_items: np.ndarray
    train_neg_items: Optional[np.ndarray] = None
    test_neg_items: Optional[np.ndarray] = None
    # (ids (U, L), mask (U, L)): user histories restored from a checkpoint.
    # Histories derive from the train split, which a cold RecSys.load does
    # not have; extend_store merges new train rows into them.
    history_override: Optional[Tuple[np.ndarray, np.ndarray]] = None

    _token_counter = itertools.count()

    def __post_init__(self) -> None:
        # process-unique cache key for the trainer's device copy of the
        # train split (``id(store)`` can be reused after collection)
        self.token = next(InteractionStore._token_counter)

    @property
    def num_train(self) -> int:
        return int(self.train_users.shape[0])

    def train_arrays(self) -> Dict[str, np.ndarray]:
        """The train split's per-interaction columns (interactions.py:70-74):
        ``user_id``, ``pos_item_id`` and, with static negatives,
        ``neg_item_id``."""
        d = {"user_id": self.train_users, "pos_item_id": self.train_items}
        if self.train_neg_items is not None:
            d["neg_item_id"] = self.train_neg_items
        return d

    @property
    def num_test(self) -> int:
        return int(self.test_users.shape[0])

    def test_arrays(self) -> Dict[str, np.ndarray]:
        """The test split's columns, as :meth:`train_arrays` (:76-80)."""
        d = {"user_id": self.test_users, "pos_item_id": self.test_items}
        if self.test_neg_items is not None:
            d["neg_item_id"] = self.test_neg_items
        return d

    def batches(
        self,
        batch_size: int,
        split: str = "train",
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Host-side batches of a split for the caller's own loop, the
        ``FastDataLoader`` surface (:82-108): dicts of numpy arrays (the
        columns of :meth:`train_arrays` or :meth:`test_arrays`), rows in
        ``np.random.default_rng(seed).shuffle`` order, the last batch short
        unless ``drop_remainder``. ``Trainer.fit`` does not use it."""
        arrays = self.train_arrays() if split == "train" else self.test_arrays()
        n = next(iter(arrays.values())).shape[0]
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for s in range(0, stop, batch_size):
            sel = idx[s : s + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}

    def write_data(self, path: str) -> None:
        """Dataset stats and the item metadata map (:110-133): ``config.json``
        (the schema's JSON) and ``meta.csv`` (one row per item: its row,
        raw id and each feature's encoded ids)."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.schema.to_json())
        m = self.metadata
        with open(os.path.join(path, "meta.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["item_row", "raw_item_id", *m.names])
            for row in range(self.schema.num_items):
                lists = [
                    [int(v) for v, ok in zip(m.ids[row, f], m.mask[row, f]) if ok]
                    for f in range(m.num_features)
                ]
                w.writerow([row, self.item_encoder.decode_one(row), *lists])

    def user_history(self, length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(num_users, length) ids of each user's last ``length`` train items
        in interaction order, left-aligned, and their mask (:135-172); the
        checkpointed ``history_override`` when its window is ``length``."""
        if self.history_override is not None:
            o_ids, o_mask = self.history_override
            if o_ids.shape[1] == length:
                return o_ids, o_mask
            if self.num_train == 0:
                raise ValueError(
                    f"checkpointed user history has window {o_ids.shape[1]} "
                    f"but {length} was requested, and this store has no "
                    "interactions to rebuild from"
                )
        n_users = self.schema.num_users
        ids = np.zeros((n_users, length), np.int32)
        mask = np.zeros((n_users, length), bool)
        if self.num_train == 0:
            return ids, mask
        _window(self.train_users, self.train_items, n_users, length, ids, mask)
        return ids, mask


def _window(users: np.ndarray, items: np.ndarray, n_users: int, length: int,
            ids: np.ndarray, mask: np.ndarray) -> None:
    """Write each user's last ``length`` (user, item) pairs, in the given
    order, left-aligned into ``ids``/``mask`` (zeroed (n_users, length)): a
    stable sort by user, then each pair's distance from its user's end
    (interactions.py:160-172 and :355-375)."""
    order = np.argsort(users, kind="stable")
    su, si = users[order], items[order]
    counts = np.bincount(su, minlength=n_users)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(su)) - starts[su]
    from_end = counts[su] - rank  # 1 = the user's most recent pair
    keep = from_end <= length
    col = np.minimum(counts[su], length) - from_end
    ids[su[keep], col[keep]] = si[keep]
    mask[su[keep], col[keep]] = True


def _columns(dataset: Any) -> Dict[str, np.ndarray]:
    if hasattr(dataset, "columns") and hasattr(dataset, "__getitem__"):
        return {c: np.asarray(dataset[c]) for c in dataset.columns}
    if isinstance(dataset, dict):
        return {
            k: v if isinstance(v, np.ndarray) else np.asarray(v, dtype=object)
            for k, v in dataset.items()
        }
    raise TypeError(f"unsupported dataset type {type(dataset)!r}")


def prepare_data(
    dataset: Any,
    user_id_col: str,
    item_id_col: str,
    metadata_id_col: Optional[Sequence[str]] = None,
    split_ratio: float = 0.8,
    dynamic_neg_sampling: bool = False,
    metadata_width: Optional[int] = None,
    seed: int = 42,
) -> InteractionStore:
    """Build an :class:`InteractionStore` from a DataFrame or column dict
    (interactions.py:175-256): encode ids, build the metadata table, split
    by a seeded permutation, and -- unless ``dynamic_neg_sampling`` -- draw
    static negatives from the same generator. Same seed, same result as
    the JAX package, bit for bit."""
    columns = _columns(dataset)
    users_raw = columns[user_id_col]
    items_raw = columns[item_id_col]
    if len(users_raw) != len(items_raw):
        raise ValueError("user and item columns differ in length")
    n = len(users_raw)

    users, user_encoder = encode_column(users_raw)
    items, item_encoder = encode_column(items_raw)
    num_users = user_encoder.vocab_size
    num_items = item_encoder.vocab_size

    meta_cols = list(metadata_id_col or [])
    if meta_cols:
        metadata = MetadataTable.build(
            items, num_items, {c: columns[c] for c in meta_cols}, width=metadata_width
        )
    else:
        metadata = MetadataTable.empty(num_items)

    schema = DataSchema(
        num_users=num_users,
        num_items=num_items,
        metadata_names=metadata.names,
        metadata_vocab_sizes=metadata.vocab_sizes,
        metadata_width=metadata.width,
    )

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(round(n * split_ratio))
    tr, te = perm[:n_train], perm[n_train:]

    train_neg = test_neg = None
    if not dynamic_neg_sampling:
        train_neg = sample_negatives_np(rng, items[tr], num_items)
        test_neg = sample_negatives_np(rng, items[te], num_items)

    return InteractionStore(
        schema=schema,
        user_encoder=user_encoder,
        item_encoder=item_encoder,
        metadata=metadata,
        train_users=users[tr],
        train_items=items[tr],
        test_users=users[te],
        test_items=items[te],
        train_neg_items=train_neg,
        test_neg_items=test_neg,
    )


def extend_store(
    store: InteractionStore,
    dataset: Any,
    user_id_col: str,
    item_id_col: str,
    split_ratio: float = 0.8,
    dynamic_neg_sampling: bool = False,
    seed: int = 43,
) -> InteractionStore:
    """A new store: ``store`` grown by the interactions of ``dataset``
    (interactions.py:259-398), bit for bit as the JAX package grows it.

    Raw ids encode through the store's own encoders in first-occurrence
    order (``IdEncoder.encode``, even for int columns: ``prepare_data``'s
    sorted ``np.unique`` path is for a fresh vocab only), so unseen users
    and items get new rows at the end and every trained row keeps its
    index; a frozen encoder raises ``KeyError`` on an unseen id. The new
    rows take their own seeded split and are appended to each split. New
    items parse their metadata from their first occurrence, unseen
    categories grow the feature vocabularies (``MetadataTable.extend``);
    ``dataset`` must carry every metadata column. With static negatives,
    the new rows draw theirs over the grown catalog. A checkpointed
    history window merges with the new train rows (each user's new items
    push in from the right). The returned store has a new ``token``, so
    the trainer's caches of the old one rebuild."""
    columns = _columns(dataset)
    users_raw = columns[user_id_col]
    items_raw = columns[item_id_col]
    if len(users_raw) != len(items_raw):
        raise ValueError("user and item columns differ in length")
    meta_names = store.metadata.names
    missing = [c for c in meta_names if c not in columns]
    if missing:
        raise ValueError(
            f"extend_store: new dataset is missing metadata column(s) "
            f"{missing} required by the store's schema"
        )

    users = store.user_encoder.encode(list(users_raw))
    items = store.item_encoder.encode(list(items_raw))
    num_users = store.user_encoder.vocab_size
    num_items = store.item_encoder.vocab_size
    if meta_names:
        metadata = store.metadata.extend(items, num_items, {c: columns[c] for c in meta_names})
    else:
        metadata = MetadataTable.empty(num_items)

    n = len(users)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(round(n * split_ratio))
    tr, te = perm[:n_train], perm[n_train:]

    def cat(a, b):
        return np.concatenate([a, b]) if len(b) else a.copy()

    hist = None
    if store.history_override is not None:
        o_ids, o_mask = store.history_override
        length = o_ids.shape[1]
        # the old windows as (user, item) pairs in stored order (row-major),
        # then the new train pairs, re-windowed
        old_u, old_slot = np.nonzero(o_mask)
        h_ids = np.zeros((num_users, length), np.int32)
        h_mask = np.zeros((num_users, length), bool)
        _window(np.concatenate([old_u.astype(np.int64), users[tr]]),
                np.concatenate([o_ids[old_u, old_slot], items[tr]]),
                num_users, length, h_ids, h_mask)
        hist = (h_ids, h_mask)

    train_neg = test_neg = None
    if store.train_neg_items is not None and not dynamic_neg_sampling:
        train_neg = cat(store.train_neg_items, sample_negatives_np(rng, items[tr], num_items))
        test_neg = cat(store.test_neg_items, sample_negatives_np(rng, items[te], num_items))

    schema = DataSchema(
        num_users=num_users,
        num_items=num_items,
        metadata_names=metadata.names,
        metadata_vocab_sizes=metadata.vocab_sizes,
        metadata_width=metadata.width,
    )
    return InteractionStore(
        schema=schema,
        user_encoder=store.user_encoder,
        item_encoder=store.item_encoder,
        metadata=metadata,
        train_users=cat(store.train_users, users[tr]),
        train_items=cat(store.train_items, items[tr]),
        test_users=cat(store.test_users, users[te]),
        test_items=cat(store.test_items, items[te]),
        train_neg_items=train_neg,
        test_neg_items=test_neg,
        history_override=hist,
    )

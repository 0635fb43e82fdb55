"""Encoded interaction store (port of
``torchrecsys_tpu/data/interactions.py``, :26-80 and :175-256).

The store is host-side numpy: encoded int32 user/item rows per split, the
static negatives, the item metadata table and the schema. Serving reads
the encoders, the schema, the metadata and the train split (for
``exclude_seen``); training reads :meth:`InteractionStore.train_arrays`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence

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

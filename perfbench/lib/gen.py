"""Inputs from the seed: interactions, raw ids, weights and request users.

The interactions follow the block-preference generator of the repo's
``bench.py::structured_interactions`` (user block b prefers item block b,
``on_block`` of the time) in the every-id-present form of
``chip_smoke.py::synthetic_interactions``: the first ``max(users, items)``
rows name every user and every item once in a seeded order, so the catalog
is exactly ``n_items`` items. Raw ids are distinct, scrambled against the
generator's indices (``perm * stride + offset``), so the facade's encoding
is exercised and checked. Same seed, same inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def np_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, stream)."""
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` per (seed, stream)."""
    mixed = (int(seed) & SEED_MASK) * 1_000_003 + stream
    return torch.Generator(device=device).manual_seed(mixed & ((1 << 64) - 1))


def interactions(data: Dict[str, int], seed: int) -> Dict[str, np.ndarray]:
    """``data``: ``n_users``, ``n_items``, ``n_interactions``, ``blocks``,
    ``on_block`` (share of rows on the user's block). Returns raw
    ``user_id`` / ``item_id`` (int64), the generator's indices ``_u`` /
    ``_i`` and every raw id ``_user_ids`` / ``_item_ids`` (each occurs)."""
    nu, ni, n = int(data["n_users"]), int(data["n_items"]), int(data["n_interactions"])
    blocks, on = int(data["blocks"]), float(data["on_block"])
    r = np_rng(seed, 0)
    m = max(nu, ni)
    if n < m:
        raise ValueError(f"n_interactions={n} cannot hold every user and item ({m})")
    cover_u = r.permutation(m) % nu
    cover_i = r.permutation(m) % ni
    rest = n - m
    users = r.integers(0, nu, rest)
    rand_items = r.integers(0, ni, rest)
    block_items = ((rand_items // blocks) * blocks + users % blocks) % ni
    items = np.where(r.random(rest) < on, block_items, rand_items)
    u = np.concatenate([cover_u, users]).astype(np.int64)
    i = np.concatenate([cover_i, items]).astype(np.int64)
    key_u = r.permutation(nu).astype(np.int64) * 7 + 3
    key_i = r.permutation(ni).astype(np.int64) * 11 + 5
    return {"user_id": key_u[u], "item_id": key_i[i], "_u": u, "_i": i, "_user_ids": key_u, "_item_ids": key_i}


def encoding(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The documented encoding of an integer id column, worked out here:
    rows are ranks in the sorted distinct raw ids. Returns (vocab, rows)."""
    vocab = np.unique(raw)
    return vocab, np.searchsorted(vocab, raw)


def vocab(ids: np.ndarray) -> np.ndarray:
    """The sorted distinct raw ids of a column from the set of its ids: what
    :func:`encoding` gives when every id of the set occurs, at the cost of
    sorting the set rather than the column."""
    return np.unique(ids)


def rows_of(vocab: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Rows of raw ids in ``vocab``; -1 where an id is not in it."""
    pos = np.searchsorted(vocab, raw)
    pos = np.minimum(pos, len(vocab) - 1)
    return np.where(vocab[pos] == raw, pos, -1)


def request_users(r: np.random.Generator, n_users: int, size: int) -> np.ndarray:
    """``size`` distinct user rows drawn uniformly."""
    if size > n_users:
        raise ValueError(f"{size} distinct users from {n_users}")
    m = size + size // 4 + 8
    while True:
        draw = np.unique(r.integers(0, n_users, m))
        if len(draw) >= size:
            return r.permutation(draw)[:size]
        m *= 2

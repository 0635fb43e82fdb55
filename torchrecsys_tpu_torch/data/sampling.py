"""Negative sampling (port of ``torchrecsys_tpu/data/sampling.py``:
``sample_negatives`` :25-49, ``sample_negatives_np`` :52-62,
``popularity_cdf`` :65-79, ``_popularity_weights`` :82-96, ``alias_table``
:99-144, ``sample_negatives_alias`` :147-191 and
``sample_negatives_weighted`` :194-233).

``prepare_data`` draws the static negatives from the split's numpy
generator right after the split permutation, so the same seed gives the
JAX package's negatives bit for bit. :func:`sample_negatives` is the
training-time uniform draw (``dynamic_neg_sampling=True``) from a
``torch.Generator`` on the device; its numbers are not the JAX package's
(threefry), its distribution is.

Popularity sampling (``p(i) ∝ count(i)^alpha``) builds its host tables
exactly as the JAX package does: :func:`alias_table` keeps the two-stack
order that ``native/ingest.cpp:158-180`` and the Python loop share, so
``prob``, ``alias`` and the top-2 ``fallback`` come out bit for bit. Each
device sampler is split in two: a draw of the uniforms from a
``torch.Generator`` (:func:`alias_uniforms`, :func:`cdf_uniforms`) and a
pure map from those uniforms to ids (:func:`alias_map`,
:func:`cdf_map`), so a test can feed in the JAX package's own uniforms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sample_negatives(
    generator: torch.Generator,
    pos_items: torch.Tensor,
    num_items: int,
    avoid_collisions: bool = True,
) -> torch.Tensor:
    """One uniform negative item row per positive, int64 of
    ``pos_items``' shape on the generator's device. With
    ``avoid_collisions`` the draw is exactly uniform over the catalog minus
    the row's positive: ``r ~ U[0, n-1)``, shifted past it; no rejection
    loop."""
    dev = generator.device
    shape = tuple(pos_items.shape)
    if avoid_collisions and num_items > 1:
        r = torch.randint(0, num_items - 1, shape, generator=generator, device=dev)
        return r + (r >= pos_items).to(torch.int64)
    return torch.randint(0, num_items, shape, generator=generator, device=dev)


def sample_negatives_np(
    rng: np.random.Generator,
    pos_items: np.ndarray,
    num_items: int,
    avoid_collisions: bool = False,
) -> np.ndarray:
    """One uniform negative item row per positive. With
    ``avoid_collisions`` the draw is uniform over the catalog minus the
    positive (``r ~ U[0, n-1)``, shifted past it)."""
    if avoid_collisions and num_items > 1:
        r = rng.integers(0, num_items - 1, size=pos_items.shape, dtype=np.int32)
        return r + (r >= pos_items).astype(np.int32)
    return rng.integers(0, num_items, size=pos_items.shape, dtype=np.int32)


# ---------------------------------------------------------------------------
# popularity tables (host, built once per store)
# ---------------------------------------------------------------------------


def _popularity_weights(
    train_items: np.ndarray, num_items: int, alpha: float
) -> Tuple[np.ndarray, float]:
    """``count^alpha`` in float64 and its sum; an empty split gives the
    uniform weights (:82-96)."""
    counts = np.bincount(np.asarray(train_items, np.int64), minlength=num_items).astype(np.float64)
    w = counts**alpha
    total = w.sum()
    if total <= 0:
        w = np.ones(num_items, np.float64)
        total = float(num_items)
    return w, total


def popularity_cdf(train_items: np.ndarray, num_items: int, alpha: float = 0.75) -> np.ndarray:
    """(num_items,) f32 CDF over ``count^alpha`` (:65-79). With ``alpha=0``
    every item the split holds has mass and items it never saw have none
    (``0**0 == 1`` makes them weigh in too: the reference's behaviour,
    kept)."""
    w, total = _popularity_weights(train_items, num_items, alpha)
    return np.cumsum(w / total).astype(np.float32)


def _vose(scaled: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker/Vose pairing of a mean-1 float64 distribution: ``small`` and
    ``large`` filled in index order, each popped from its back, ``prob[s]``
    the small slot's weight rounded to f32, ``l`` pushed back onto the
    stack its new weight selects; leftovers keep ``prob = 1`` and alias
    themselves (native/ingest.cpp:158-180)."""
    n = scaled.shape[0]
    w = scaled.tolist()  # Python floats: the same float64 arithmetic
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    is_small = scaled < 1.0
    small = np.flatnonzero(is_small).tolist()
    large = np.flatnonzero(~is_small).tolist()
    pop_s, pop_l, push_s, push_l = small.pop, large.pop, small.append, large.append
    ps, al = [], []
    while small and large:
        s, l = pop_s(), pop_l()
        ps.append(s)
        al.append(l)
        ws = w[s]
        wl = w[l] - (1.0 - ws)
        w[l] = wl
        (push_s if wl < 1.0 else push_l)(l)
    if ps:
        idx = np.asarray(ps, np.int64)
        prob[idx] = np.asarray(w, np.float64)[idx]  # a small slot's weight is final once popped
        alias[idx] = np.asarray(al, np.int64)
    return prob.astype(np.float32), alias.astype(np.int32)


def alias_table(
    train_items: np.ndarray, num_items: int, alpha: float = 0.75
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walker alias table for ``p(i) ∝ count(i)^alpha`` (:99-144):
    ``(prob f32 (N,), alias i32 (N,), fallback i32 (2,))``, the JAX
    package's tables bit for bit. ``fallback`` holds the two heaviest items
    (``argpartition``, then the heavier first): the escape of a draw that
    collides with its positive twice. Zero-count items get ``prob = 0`` in
    a slot aliased to a popular item, so they are never drawn."""
    w, total = _popularity_weights(train_items, num_items, alpha)
    scaled = w / total * num_items  # mean 1
    if num_items >= 2:
        top2 = np.argpartition(-w, 1)[:2].astype(np.int32)
        if w[top2[1]] > w[top2[0]]:
            top2 = top2[::-1].copy()
    else:
        top2 = np.zeros(2, np.int32)
    prob, alias = _vose(scaled)
    return prob, alias, top2


def pack_alias(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """``(N, 2)`` int32: the f32 bits of ``prob`` beside ``alias``, so a
    draw reads both with one row gather (:171-175)."""
    return torch.stack([prob.to(torch.float32).view(torch.int32), alias.to(torch.int32)], dim=1)


# ---------------------------------------------------------------------------
# device draws: uniforms, then a pure map to ids
# ---------------------------------------------------------------------------

AliasUniforms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def alias_uniforms(generator: torch.Generator, shape, num_items: int) -> AliasUniforms:
    """The uniforms of one alias draw and its collision redraw:
    ``(slot, coin, slot2, coin2)``, slots int64 in ``[0, N)``, coins f32
    in ``[0, 1)``, on the generator's device."""
    dev = generator.device
    shape = tuple(shape)
    out = []
    for _ in range(2):
        out.append(torch.randint(0, num_items, shape, generator=generator, device=dev))
        out.append(torch.rand(shape, generator=generator, device=dev, dtype=torch.float32))
    return tuple(out)


def alias_map(
    pos_items: torch.Tensor,
    packed: torch.Tensor,
    fallback: torch.Tensor,
    uniforms: AliasUniforms,
    avoid_collisions: bool = True,
) -> torch.Tensor:
    """Alias draws from their uniforms (:147-191): ``coin < prob[slot] ?
    slot : alias[slot]`` (one row gather of ``packed``), then with
    ``avoid_collisions`` one redraw for rows equal to their positive and,
    for a second collision, the heavier fallback item that is not the
    positive. ``pos_items`` broadcasts against the uniforms' shape; int64
    ids of that shape."""
    slot, coin, slot2, coin2 = uniforms

    def draw(s, c):
        rows = packed[s.reshape(-1)]
        p = rows[:, 0].contiguous().view(torch.float32).reshape(s.shape)
        a = rows[:, 1].to(torch.int64).reshape(s.shape)
        return torch.where(c < p, s, a)

    neg = draw(slot, coin)
    if avoid_collisions and packed.shape[0] > 1:
        pos = pos_items.expand(neg.shape)
        neg = torch.where(neg == pos, draw(slot2, coin2), neg)
        fb = fallback.to(torch.int64)
        escape = torch.where(pos == fb[0], fb[1], fb[0])
        neg = torch.where(neg == pos, escape, neg)
    return neg


def sample_negatives_alias(
    generator: torch.Generator,
    pos_items: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    fallback: torch.Tensor,
    avoid_collisions: bool = True,
    shape=None,
) -> torch.Tensor:
    """Popularity negatives of ``shape`` (default ``pos_items``' shape;
    ``(K, B)`` for K draws per row) from the alias tables, drawn on the
    generator's device through one packed ``(N, 2)`` table."""
    shape = tuple(pos_items.shape) if shape is None else tuple(shape)
    u = alias_uniforms(generator, shape, prob.shape[0])
    return alias_map(pos_items, pack_alias(prob, alias), fallback, u, avoid_collisions)


def cdf_uniforms(generator: torch.Generator, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 uniforms of one inverse-CDF draw and its collision redraw."""
    dev = generator.device
    return tuple(torch.rand(tuple(shape), generator=generator, device=dev) for _ in range(2))


def cdf_map(
    pos_items: torch.Tensor,
    cdf: torch.Tensor,
    uniforms: Tuple[torch.Tensor, torch.Tensor],
    avoid_collisions: bool = True,
) -> torch.Tensor:
    """Inverse-CDF draws from their uniforms (:194-233): ``searchsorted(cdf,
    u, side="right")`` clamped to ``N - 1``, one redraw for rows equal to
    their positive, then ``+1 mod N`` for a second collision."""
    n = cdf.shape[0]

    def draw(u):
        return torch.clamp_max(torch.searchsorted(cdf, u, right=True), n - 1)

    neg = draw(uniforms[0])
    if avoid_collisions and n > 1:
        pos = pos_items.expand(neg.shape)
        neg = torch.where(neg == pos, draw(uniforms[1]), neg)
        neg = torch.where(neg == pos, (neg + 1) % n, neg)
    return neg


def sample_negatives_weighted(
    generator: torch.Generator,
    pos_items: torch.Tensor,
    cdf: torch.Tensor,
    avoid_collisions: bool = True,
) -> torch.Tensor:
    """Popularity negatives by inverse CDF: the straightforward version the
    alias draw is held against."""
    return cdf_map(pos_items, cdf, cdf_uniforms(generator, pos_items.shape), avoid_collisions)

"""Uniform negative sampling (port of ``torchrecsys_tpu/data/sampling.py``,
``sample_negatives`` :25-49 and ``sample_negatives_np`` :52-62).

``prepare_data`` draws the static negatives from the split's numpy
generator right after the split permutation, so the same seed gives the
JAX package's negatives bit for bit. :func:`sample_negatives` is the
training-time draw (``dynamic_neg_sampling=True``) from a
``torch.Generator`` on the device; its numbers are not the JAX package's
(threefry), its distribution is. The popularity and alias samplers are
still to be ported (ROADMAP.md §A item 7).
"""

from __future__ import annotations

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

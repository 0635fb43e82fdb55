"""Host-side negative sampling (port of ``sample_negatives_np``,
``torchrecsys_tpu/data/sampling.py:52-62``).

``prepare_data`` draws the static negatives from the split's numpy
generator right after the split permutation, so the same seed gives the
JAX package's negatives bit for bit. The in-step device samplers arrive
with the training slice.
"""

from __future__ import annotations

import numpy as np


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

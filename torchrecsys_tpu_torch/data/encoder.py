"""Explicit id <-> row encoding (port of ``torchrecsys_tpu/data/encoder.py``,
:18-141).

Every raw id (int, string, anything hashable) maps to a dense contiguous
row index, and predictions decode back to raw ids. Only the numpy and
Python paths are ported; the JAX package's C++ string encoder gives the
same first-occurrence codes as the Python dict path used here.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np


class IdEncoder:
    """Bidirectional mapping raw id -> contiguous int32 row index. A frozen
    encoder (a cold-loaded store's, :33-46) refuses unseen ids."""

    def __init__(self) -> None:
        self._to_index: Dict[Any, int] = {}
        self._to_raw: List[Any] = []
        self._frozen = False

    def __len__(self) -> int:
        return len(self._to_raw)

    @property
    def vocab_size(self) -> int:
        return len(self._to_raw)

    def freeze(self) -> "IdEncoder":
        self._frozen = True
        return self

    @property
    def frozen(self) -> bool:
        return self._frozen

    def thaw(self) -> "IdEncoder":
        """Re-allow vocab growth (``RecSys.update_data`` thaws a cold-loaded
        store's encoders around the extension and refreezes them)."""
        self._frozen = False
        return self

    def fit(self, values: Iterable[Any]) -> "IdEncoder":
        """Add unseen ids in first-occurrence order; a frozen encoder raises
        ``KeyError`` on the first unseen one (:48-55)."""
        for v in values:
            if v not in self._to_index:
                if self._frozen:
                    raise KeyError(f"unknown id {v!r} (encoder is frozen)")
                self._to_index[v] = len(self._to_raw)
                self._to_raw.append(v)
        return self

    def encode(self, values: Sequence[Any]) -> np.ndarray:
        """Encode raw ids to int32 row indices, adding unseen ids (raising
        ``KeyError`` on one when frozen)."""
        self.fit(values)
        to_index = self._to_index
        return np.fromiter((to_index[v] for v in values), np.int32, len(values))

    def encode_one(self, value: Any) -> int:
        try:
            return self._to_index[value]
        except KeyError:
            sample = ", ".join(repr(v) for v in self._to_raw[:5])
            raise KeyError(
                f"unknown id {value!r}: not among the {len(self._to_raw)} raw "
                f"ids this encoder was built from (e.g. {sample}). Ids are "
                "matched by exact value and type -- an int 3 does not match a "
                "string '3'."
            ) from None

    def decode(self, indices: Sequence[int]) -> List[Any]:
        to_raw = self._to_raw
        return [to_raw[int(i)] for i in indices]

    def decode_one(self, index: int) -> Any:
        return self._to_raw[int(index)]

    def __contains__(self, value: Any) -> bool:
        return value in self._to_index

    @classmethod
    def from_values(cls, values: Iterable[Any]) -> "IdEncoder":
        """An encoder fitted on ``values``, rows in first-seen order (:90-92)."""
        return cls().fit(values)

    def to_list(self) -> List[Any]:
        """The vocabulary in row order: enough to rebuild the encoder."""
        return list(self._to_raw)

    @classmethod
    def from_list(cls, raw: List[Any]) -> "IdEncoder":
        """An (unfrozen) encoder over ``raw`` in row order (:99-105)."""
        enc = cls()
        enc._to_raw = list(raw)
        enc._to_index = {v: i for i, v in enumerate(raw)}
        return enc


def encode_column(values: Sequence[Any]) -> Tuple[np.ndarray, IdEncoder]:
    """Build an encoder over ``values`` and encode them (encoder.py:107-141).

    Integer columns take vectorized ``np.unique`` (sorted vocab); everything
    else -- strings included -- the Python dict path (first-occurrence
    vocab, which is also what the JAX package's C++ string encoder yields).
    Object columns of strings become numpy unicode first, as in JAX, so the
    decoded raw ids have the same type."""
    arr = np.asarray(values)
    if arr.dtype.kind == "O":
        sample = next((v for v in arr[: min(len(arr), 16)] if v is not None), None)
        if isinstance(sample, str):
            try:
                arr = arr.astype("U")
            except (ValueError, TypeError):
                pass
    if arr.dtype.kind in "iu":
        uniq, inv = np.unique(arr, return_inverse=True)
        enc = IdEncoder()
        enc._to_raw = [int(u) for u in uniq]
        enc._to_index = {int(u): i for i, u in enumerate(uniq)}
        return inv.astype(np.int32), enc
    if arr.dtype.kind in "US":
        enc = IdEncoder()
        return enc.encode(arr.tolist()), enc
    enc = IdEncoder()
    return enc.encode(list(values)), enc

"""Item metadata as fixed-width multi-hot buckets (port of
``torchrecsys_tpu/data/metadata.py``, :29-243).

Cells may be scalars, Python lists/tuples/arrays, or string-serialized
lists; every feature is encoded to its own contiguous vocab and padded to
one shared width with an explicit boolean mask.

Vocab order follows the JAX package exactly: a text column whose every
cell is an integer list (``"[3, 7]"``) gets a SORTED integer vocab -- the
JAX package parses such columns in C++ (native/ingest.cpp:69-122) and
encodes with ``np.unique``; :func:`_parse_int_list_cells` is that parser's
grammar in Python. Every other column takes the per-cell Python parse with
a first-occurrence vocab.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchrecsys_tpu_torch.data.encoder import IdEncoder


def parse_metadata_cell(cell: Any) -> List[Any]:
    """Normalize one metadata cell to a list of raw category ids
    (metadata.py:29-53)."""
    if cell is None:
        return []
    if isinstance(cell, str):
        s = cell.strip()
        if s.startswith("[") or s.startswith("("):
            try:
                cell = ast.literal_eval(s)
            except (ValueError, SyntaxError):
                return [cell]
        else:
            return [cell]
    if isinstance(cell, np.ndarray):
        return list(cell.tolist())
    if isinstance(cell, (list, tuple)):
        return list(cell)
    if isinstance(cell, float) and np.isnan(cell):
        return []
    return [cell]


def parse_metadata_column(
    cells: Sequence[Any],
    encoder: Optional[IdEncoder] = None,
) -> Tuple[List[List[int]], IdEncoder]:
    """Parse + encode a whole metadata column to lists of contiguous ids
    (metadata.py:56-67)."""
    enc = encoder if encoder is not None else IdEncoder()
    out: List[List[int]] = []
    for cell in cells:
        raw = parse_metadata_cell(cell)
        enc.fit(raw)
        out.append([enc.encode_one(v) for v in raw])
    return out, enc


_LIST_PUNCT = frozenset("[](), \t\0")


def _parse_int_list_cell(text) -> Optional[List[int]]:
    """One cell under the grammar of native/ingest.cpp:72-104: runs of
    digits are integers, a '-' negates the next one, brackets, parentheses,
    commas and blanks separate; anything else -> None. Values wrap to int32
    as the C++ cast does."""
    out: List[int] = []
    val, in_num, neg = 0, False, False
    for ch in text:
        if "0" <= ch <= "9":
            val = val * 10 + (ord(ch) - 48)
            in_num = True
            continue
        if in_num:
            out.append(-val if neg else val)
            val, in_num, neg = 0, False, False
        if ch == "-":
            neg = True
        elif ch in _LIST_PUNCT:
            neg = False
        else:
            return None
    if in_num:
        out.append(-val if neg else val)
    return [(v + 2**31) % 2**32 - 2**31 for v in out]


def _parse_int_list_cells(arr: np.ndarray) -> Optional[List[List[int]]]:
    """Every cell of a text column as an int list, or None if any cell is
    not one. The C++ parser reads one byte per UTF-32 unit (its low byte),
    which this mirrors."""
    out = []
    for cell in arr.tolist():
        if isinstance(cell, bytes):
            text = cell.decode("latin-1")
        else:
            text = "".join(chr(ord(c) & 0xFF) for c in cell)
        lst = _parse_int_list_cell(text)
        if lst is None:
            return None
        out.append(lst)
    return out


def _cells_to_lists(cells: Any) -> Tuple[List[List[int]], IdEncoder]:
    """Parse + encode a batch of metadata cells into id lists
    (metadata.py:76-107)."""
    arr = np.asarray(cells)
    if arr.dtype.kind == "O":
        sample = next((v for v in arr[: min(len(arr), 16)] if v is not None), None)
        if isinstance(sample, str):
            try:
                arr = arr.astype("U")
            except (ValueError, TypeError):
                pass
    if arr.dtype.kind in "US":
        lists = _parse_int_list_cells(arr)
        if lists is not None:
            values = np.asarray([v for lst in lists for v in lst], np.int32)
            uniq = np.unique(values)
            enc = IdEncoder()
            enc._to_raw = [int(u) for u in uniq]
            enc._to_index = {int(u): i for i, u in enumerate(uniq)}
            return [[enc._to_index[v] for v in lst] for lst in lists], enc
    return parse_metadata_column(list(cells))


class MetadataTable:
    """Per-item metadata as dense ``(num_items, F, W)`` buckets
    (metadata.py:110-189): ``ids[i, f, :]`` are the encoded category ids of
    feature ``f`` for item row ``i``; ``mask[i, f, :]`` flags the valid
    slots."""

    def __init__(
        self,
        ids: np.ndarray,  # (num_items, F, W) int32
        mask: np.ndarray,  # (num_items, F, W) bool
        names: Tuple[str, ...],
        encoders: Tuple[IdEncoder, ...],
    ) -> None:
        if ids.ndim != 3 or ids.shape != mask.shape:
            raise ValueError(f"metadata ids {ids.shape} / mask {mask.shape} mismatch")
        self.ids = ids
        self.mask = mask
        self.names = names
        self.encoders = encoders

    @property
    def num_items(self) -> int:
        return self.ids.shape[0]

    @property
    def num_features(self) -> int:
        return self.ids.shape[1]

    @property
    def width(self) -> int:
        return self.ids.shape[2]

    @property
    def vocab_sizes(self) -> Tuple[int, ...]:
        return tuple(len(e) for e in self.encoders)

    @classmethod
    def build(
        cls,
        item_rows: np.ndarray,  # (N,) encoded item row per interaction
        num_items: int,
        columns: Dict[str, Sequence[Any]],  # metadata col name -> N cells
        width: Optional[int] = None,
    ) -> "MetadataTable":
        """The item -> metadata map from interaction-aligned columns; the
        first occurrence of each item defines its metadata."""
        names = tuple(columns.keys())
        uniq_items, first_idx = np.unique(item_rows, return_index=True)
        per_col = []
        for name in names:
            col = columns[name]
            cells = (col if isinstance(col, np.ndarray) else np.asarray(col))[first_idx]
            per_col.append(_cells_to_lists(cells))
        max_len = max([1] + [len(lst) for lists, _ in per_col for lst in lists])
        w = width if width is not None else max_len
        ids = np.zeros((num_items, len(names), w), dtype=np.int32)
        mask = np.zeros((num_items, len(names), w), dtype=bool)
        for f, (lists, _) in enumerate(per_col):
            for it, lst in zip(uniq_items, lists):
                k = min(len(lst), w)
                if k:
                    ids[it, f, :k] = lst[:k]
                    mask[it, f, :k] = True
        return cls(ids, mask, names, tuple(e for _, e in per_col))

    def gather(self, item_batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B,) item rows -> ((B, F, W) ids, (B, F, W) mask) (:191-193)."""
        return self.ids[item_batch], self.mask[item_batch]

    def extend(
        self,
        item_rows: np.ndarray,  # (N,) encoded item rows of the new interactions
        num_items_new: int,
        columns: Dict[str, Sequence[Any]],  # name -> N interaction-aligned cells
    ) -> "MetadataTable":
        """The table grown to ``num_items_new`` rows (metadata.py:195-233).
        Known items keep their rows untouched; a new item parses its cells
        from its first occurrence through the per-cell Python path and the
        existing per-feature encoders, which grow for unseen categories
        (trained metadata rows keep their indices). Lists longer than the
        width are clipped to it."""
        if set(columns) != set(self.names):
            raise ValueError(
                f"metadata columns {sorted(columns)} do not match the "
                f"store's features {sorted(self.names)}"
            )
        old_n, w = self.num_items, self.width
        ids = np.zeros((num_items_new, self.num_features, w), dtype=np.int32)
        mask = np.zeros((num_items_new, self.num_features, w), dtype=bool)
        ids[:old_n] = self.ids
        mask[:old_n] = self.mask
        uniq_items, first_idx = np.unique(item_rows, return_index=True)
        new_sel = uniq_items >= old_n
        uniq_new, first_new = uniq_items[new_sel], first_idx[new_sel]
        for f, name in enumerate(self.names):
            col = columns[name]
            cells = (col if isinstance(col, np.ndarray) else np.asarray(col))[first_new]
            lists, _ = parse_metadata_column(list(cells), encoder=self.encoders[f])
            for it, lst in zip(uniq_new, lists):
                k = min(len(lst), w)
                if k:
                    ids[it, f, :k] = lst[:k]
                    mask[it, f, :k] = True
        return MetadataTable(ids, mask, self.names, self.encoders)

    @classmethod
    def empty(cls, num_items: int) -> "MetadataTable":
        return cls(
            np.zeros((num_items, 0, 0), dtype=np.int32),
            np.zeros((num_items, 0, 0), dtype=bool),
            (),
            (),
        )

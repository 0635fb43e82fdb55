"""EASE, the closed-form linear autoencoder (port of
``torchrecsys_tpu/models/ease.py``: ``_gram_chunk`` :38-49, ``_EXACT_INV_MAX_N``
:52-55, ``_inv_spd_newton`` :58-96, ``_solve_b`` :99-107, ``EASE``
:110-267).

From the binary user x item matrix ``X``: ``P = (X^T X + lam I)^-1``,
``B = -P / diag(P)`` with ``diag(B) = 0``, and a user's scores ``X[u] @ B``.
The interactions are a CSR sorted by user, built on the host with numpy
exactly as the JAX package builds it. The Gram matrix ``G = X^T X``
accumulates over chunks of users: each chunk forms only its (C, I) slab of
X on the device, so peak memory is O(I^2 + C I) whatever the user count.

G holds co-occurrence counts, integers below 2^24, so it is exact in f32
in any order of summation. On the card the slab products run on the TF32
tensor cores (0 and 1 are exact in TF32, the sums accumulate in f32); the
solve and the scores run IEEE f32 matmuls. The JAX package has no Pallas
kernel here (an XLA matmul, ``jnp.linalg.inv`` and ``lax.top_k``), and the
port none either: ``torch.linalg.inv`` is the counterpart of
``jnp.linalg.inv``, and the top-k is a stable descending sort.

EASE has no gradient training, so it is not a :class:`RecModel`; the
facade builds it directly (``RecSys(net_type="ease")``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

# The JAX package takes the iterative solve on a TPU beyond this catalog
# size, where its LU custom-calls exceed their VMEM panel limit (:52-55).
# The port is never on a TPU, so ``solve="auto"`` is always the exact solve.
_EXACT_INV_MAX_N = 8192


@contextlib.contextmanager
def _tf32(device: torch.device, enabled: bool):
    """Matmuls on the card with TF32 tensor cores on or off; nothing on the
    CPU (its matmuls are IEEE f32)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _inv_spd_newton(a: torch.Tensor, lam_min: float) -> Tuple[torch.Tensor, int]:
    """Inverse of a symmetric positive-definite matrix by Newton-Schulz
    iteration ``X <- X (2I - A X)`` (:58-96): ``lam_max`` from 30 power
    steps from ``ones / sqrt(n)``, ``X0 = 2 / (1.01 lam_max + lam_min) I``,
    then iterations while the residual ``||I - A X||_F / sqrt(n)`` (of the
    previous iterate) is above 1e-6 and fewer than 60 have run. Returns the
    inverse and the number of iterations. The caller runs it with IEEE f32
    matmuls: under TF32 the residual stalls above 1e-6."""
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    v = torch.ones((n, 1), dtype=a.dtype, device=a.device) / math.sqrt(1.0 * n)
    for _ in range(30):
        v = a @ v
        v = v / torch.linalg.vector_norm(v)
    lam_max = (v.T @ (a @ v))[0, 0] / (v.T @ v)[0, 0]
    x = (2.0 / (1.01 * lam_max + lam_min)) * eye
    res, k = 1.0, 0
    while res > 1e-6 and k < 60:
        y = a @ x
        res = float(torch.linalg.vector_norm(eye - y) / math.sqrt(1.0 * n))
        x = x @ (2.0 * eye - y)
        k += 1
    return x, k


def _solve_b(g: torch.Tensor, lam: float, exact: bool = True) -> torch.Tensor:
    """``B`` from the Gram matrix (:99-107), overwriting ``g``:
    ``A = G + lam I``, ``P = inv(A)``, ``B = -P / diag(P)[None, :]``, then
    ``diag(B) = 0`` as JAX's ``b * (1 - I)`` leaves it (-0.0)."""
    a = g
    a.diagonal().add_(lam)
    with _tf32(a.device, False):
        p = torch.linalg.inv(a) if exact else _inv_spd_newton(a, lam)[0]
    del a, g
    p.div_(p.diagonal().neg()[None, :])  # -p / d: negation is exact
    p.diagonal().mul_(0.0)
    return p


def topk_rows(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's top ``k`` values and column ids, descending, the lowest id
    first among ties (``lax.top_k``'s order), by a stable descending sort:
    the port never uses ``torch.topk``, whose order among ties is not
    promised. The top-k kernels (#1/#2) cannot take EASE's scores: they
    score ``D``-wide factor vectors with ``D <= 128`` (``dot_topk.cu:102``),
    and EASE's score width is the catalog."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


class EASE:
    """The interaction CSR, its ``B`` on ``device`` and the serving calls
    (:110-267)."""

    def __init__(
        self,
        num_users: int,
        num_items: int,
        lam: float = 100.0,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.num_users = num_users
        self.num_items = num_items
        self.lam = lam
        self.device = torch.device(device)
        # CSR by user: items of user u are item_idx[user_ptr[u]:user_ptr[u+1]]
        self.user_ptr: Optional[np.ndarray] = None  # (U+1,) int64
        self.item_idx: Optional[np.ndarray] = None  # (nnz,) int32
        self.b: Optional[torch.Tensor] = None
        self._dev_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # ---- interaction set ------------------------------------------------
    def _set_pairs(self, users: np.ndarray, items: np.ndarray) -> None:
        """Store the deduped (user, item) set as CSR, merged with any pairs
        already held (:121-138; binary X: merging is idempotent)."""
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        if self.item_idx is not None:
            old_u = np.repeat(
                np.arange(len(self.user_ptr) - 1, dtype=np.int64), np.diff(self.user_ptr)
            )
            users = np.concatenate([old_u, users])
            items = np.concatenate([self.item_idx.astype(np.int64), items])
        # np.unique's result by a sort and a neighbour compare: numpy 2.3's
        # np.unique is far slower than np.sort at millions of keys
        # (chip_smoke.py 6p prints both)
        key = np.sort(users * self.num_items + items)
        keep = np.ones(key.shape, bool)
        keep[1:] = key[1:] != key[:-1]
        key = key[keep]
        users, items = key // self.num_items, key % self.num_items
        counts = np.bincount(users, minlength=self.num_users)
        self.user_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.item_idx = items.astype(np.int32)  # sorted by (user, item)
        self._dev_csr = None

    def seed_csr(self, user_ptr: np.ndarray, item_idx: np.ndarray) -> None:
        """Adopt a checkpointed CSR, grown to ``num_users`` if needed
        (:140-151), so a later :meth:`fit` merges new interactions with it."""
        user_ptr = np.asarray(user_ptr, np.int64)
        if len(user_ptr) - 1 < self.num_users:
            pad = np.full(self.num_users + 1 - len(user_ptr), user_ptr[-1], np.int64)
            user_ptr = np.concatenate([user_ptr, pad])
        self.user_ptr = user_ptr
        self.item_idx = np.asarray(item_idx, np.int32)
        self._dev_csr = None

    def _rows(self, user_ids: np.ndarray) -> torch.Tensor:
        """The binary X rows of ``user_ids`` only, (B, I) f32 on the device
        (:153-166), formed there from the CSR, which is uploaded once."""
        if self._dev_csr is None:
            self._dev_csr = (
                torch.as_tensor(self.user_ptr, device=self.device),
                torch.as_tensor(self.item_idx.astype(np.int64), device=self.device),
            )
        ptr, idx = self._dev_csr
        u = torch.as_tensor(np.asarray(user_ids, np.int64), device=self.device)
        starts = ptr[u]
        counts = ptr[u + 1] - starts
        total = int(counts.sum())
        rows = torch.zeros((len(u), self.num_items), dtype=torch.float32, device=self.device)
        if total:
            # flat CSR offsets of every (row, slot) pair
            first = torch.repeat_interleave(starts - (torch.cumsum(counts, 0) - counts), counts, output_size=total)
            rr = torch.repeat_interleave(torch.arange(len(u), device=self.device), counts, output_size=total)
            rows[rr, idx[first + torch.arange(total, device=self.device)]] = 1.0
        return rows

    def seen_items(self, user_id: int) -> np.ndarray:
        return self.item_idx[self.user_ptr[user_id] : self.user_ptr[user_id + 1]]

    @property
    def nnz(self) -> int:
        return 0 if self.item_idx is None else int(self.item_idx.shape[0])

    # ---- solve ----------------------------------------------------------
    def gram(self, user_chunk: int = 4096) -> torch.Tensor:
        """``X^T X`` (I, I) f32 over chunks of ``user_chunk`` users
        (:196-232): each chunk's (C, I) slab of X, then ``G += x^T x``; on
        the card on the TF32 tensor cores (exact: the sums are integers
        below 2^24)."""
        c = min(user_chunk, self.num_users)
        g = torch.zeros((self.num_items, self.num_items), dtype=torch.float32, device=self.device)
        with _tf32(self.device, True):
            for lo in range(0, self.num_users, c):
                x = self._rows(np.arange(lo, min(lo + c, self.num_users)))
                g.addmm_(x.T, x)
        return g

    def fit(
        self,
        users: np.ndarray,
        items: np.ndarray,
        user_chunk: int = 4096,
        solve: str = "auto",
    ) -> "EASE":
        """users/items: (N,) encoded interaction rows (implicit feedback),
        merged with the interactions this instance already holds, then
        solved again (:168-233). ``solve``: ``"exact"`` (``torch.linalg.inv``),
        ``"iterative"`` (Newton-Schulz) or ``"auto"``: the JAX package's
        rule, exact up to ``_EXACT_INV_MAX_N`` items or off a TPU, which is
        always exact here."""
        if solve == "auto":
            exact = self.num_items <= _EXACT_INV_MAX_N or self.device.type != "tpu"
        elif solve in ("exact", "iterative"):
            exact = solve == "exact"
        else:
            raise ValueError(f"solve must be 'auto', 'exact' or 'iterative'; got {solve!r}")
        self._set_pairs(users, items)
        self.b = None  # free the old (I, I) B before G, another (I, I), is formed
        self.b = _solve_b(self.gram(user_chunk), self.lam, exact=exact)
        return self

    # ---- serving --------------------------------------------------------
    def scores(self, user_ids: np.ndarray) -> torch.Tensor:
        """(B,) users -> (B, num_items) scores ``X[u] @ B`` (:236-245), an
        IEEE f32 matmul."""
        if self.b is None:
            raise RuntimeError("EASE.scores requires a solve -- call fit() first")
        if self.item_idx is None:
            raise RuntimeError(
                "EASE has no interaction rows to score users from (checkpoint "
                "saved without its CSR sidecar?)"
            )
        with _tf32(self.device, False):
            return self._rows(user_ids) @ self.b

    def predict(self, user_id: int, top_k: int = 10, exclude_seen: bool = True) -> np.ndarray:
        """Top-k item rows for one user (:247-259), seen items excluded by
        default."""
        s = self.scores(np.asarray([user_id]))[0]
        if exclude_seen:
            seen = torch.as_tensor(self.seen_items(user_id).astype(np.int64), device=self.device)
            s[seen] = -math.inf
        return topk_rows(s, top_k)[1].cpu().numpy()

    def get_similarity(self, item_id: int, top_k: int = 10) -> np.ndarray:
        """Top-k items by ``B`` row weight (:261-267)."""
        if self.b is None:
            raise RuntimeError("EASE.get_similarity requires a solve -- call fit() first")
        return topk_rows(self.b[item_id], top_k)[1].cpu().numpy()

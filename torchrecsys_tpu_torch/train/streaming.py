"""Host-to-device double-buffered streaming fit (port of
``torchrecsys_tpu/train/streaming.py``: ``SuperBatchStream`` :32-107,
``fit_streaming`` :109-164) for train splits larger than device memory.

The split is cut into fixed super-batches (chunk i = rows ``[i sb,
min((i+1) sb, n))``, the trailing partial chunk included), visited in a
fresh ``np.random.default_rng(seed)`` order each epoch; each chunk trains
as one epoch of :meth:`Trainer.train_epoch` (its own shuffle and batches).
On the card the next chunk is staged while the current one trains: a
worker thread copies its rows into one of two pinned host buffers of
``sb`` rows (numpy's copy releases the interpreter lock, so the step loop
goes on) and issues the host-to-device copy on a side CUDA stream; the
compute stream waits on that copy's event before it reads the chunk. A
pinned buffer is refilled only after its last copy has finished (its
event), and each chunk's device tensors are recorded on the compute stream
(``record_stream``), so the allocator does not hand their memory out again
before the steps that read them have run. On the CPU the chunks are plain
slices. Chunks arrive as int64, the resident split's dtype
(``Trainer._device_train_data``).

On a mesh (``sharding=batch_sharding(mesh)``, parallel/sharding.py) each
rank stages only its ``data`` shard of each chunk (rows ``[r c/d, (r+1)
c/d)`` of a chunk of c rows), and a trailing chunk that does not split
over ``data`` comes whole to every rank, replicated, as in JAX (:63-75).
:func:`fit_streaming` on a mesh stages the whole chunk on every rank
instead: the mesh's :meth:`Trainer.train_epoch` builds the global epoch
(its permutation and batches) on every rank alike and keeps its ``data``
slice of each batch (train/trainer.py), and every rank holds the whole
host split already.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchrecsys_tpu_torch.parallel.sharding import Sharding, batch_rows
from torchrecsys_tpu_torch.utils.logging import get_logger

log = get_logger("torchrecsys_tpu_torch.streaming")

Chunk = Dict[str, torch.Tensor]


class SuperBatchStream:
    """Super-batches of ``arrays`` (host numpy columns of equal length) on
    ``device``, one chunk staged ahead on the card. ``sharding``
    (``batch_sharding(mesh)``) gives each rank its ``data`` shard of each
    chunk, on the mesh's device (a trailing chunk that does not split over
    ``data`` whole)."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        superbatch_size: int,
        seed: int = 0,
        sharding: Any = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if sharding is not None:
            if not isinstance(sharding, Sharding) or sharding.spec[:1] != ("data",):
                raise TypeError(f"sharding must be parallel.sharding.batch_sharding(mesh), got {sharding!r}")
            device = sharding.mesh.device
        self.sharding = sharding
        self.n = next(iter(arrays.values())).shape[0]
        if not all(v.shape[0] == self.n for v in arrays.values()):
            raise ValueError("array lengths differ")
        self.sb = min(superbatch_size, self.n)
        self.num_super = -(-self.n // self.sb)
        self.arrays = arrays
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device={str(device)!r} was requested but torch finds no CUDA "
                    "device; pass device='cpu' to stream on the CPU"
                )
            self._pinned = [
                {k: torch.empty((self.sb,) + v.shape[1:], dtype=torch.int64, pin_memory=True)
                 for k, v in arrays.items()}
                for _ in range(2)
            ]
            self._copied: List[Optional[torch.cuda.Event]] = [None, None]
            self._stream = torch.cuda.Stream(self.device)

    def _bounds(self, chunk_idx: int) -> Tuple[int, int]:
        """This rank's rows of chunk ``chunk_idx``: all of them, or its
        ``data`` shard when the chunk splits over the mesh's ``data``."""
        start = chunk_idx * self.sb
        stop = min(start + self.sb, self.n)
        if self.sharding is not None and (stop - start) % self.sharding.mesh.shape["data"] == 0:
            lo, hi = batch_rows(stop - start, self.sharding.mesh)
            return start + lo, start + hi
        return start, stop

    def _stage(self, chunk_idx: int, slot: int) -> Tuple[Chunk, torch.cuda.Event]:
        """Copy chunk ``chunk_idx`` into pinned buffer ``slot`` and issue its
        host-to-device copy on the side stream; the chunk's device tensors
        and the event that marks the copy's end."""
        start, stop = self._bounds(chunk_idx)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the buffer's last copy has read it
        host = {k: buf[: stop - start] for k, buf in self._pinned[slot].items()}
        for k, buf in host.items():
            np.copyto(buf.numpy(), self.arrays[k][start:stop], casting="safe")
        with torch.cuda.stream(self._stream):
            out = {k: buf.to(self.device, non_blocking=True) for k, buf in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        return out, done

    def epoch(self) -> Iterator[Chunk]:
        """Every super-batch once, in a fresh random order; on the card the
        next one is staged while the caller trains on the current one."""
        order = [int(i) for i in self.rng.permutation(self.num_super)]
        if self.device.type != "cuda":
            for i in order:
                start, stop = self._bounds(i)
                yield {k: torch.from_numpy(v[start:stop].astype(np.int64)) for k, v in self.arrays.items()}
            return
        compute = torch.cuda.current_stream(self.device)
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(self._stage, order[0], 0)
            for j in range(self.num_super):
                chunk, done = pending.result()
                if j + 1 < self.num_super:
                    pending = pool.submit(self._stage, order[j + 1], (j + 1) % 2)
                compute.wait_event(done)
                for t in chunk.values():
                    t.record_stream(compute)
                yield chunk


def fit_streaming(
    trainer,
    state: Dict[str, Any],
    store,
    superbatch_size: int = 1 << 21,
    epochs: Optional[int] = None,
    seed: int = 0,
    verbose: bool = True,
    keys: Optional[Sequence[torch.Tensor]] = None,
    negatives: Optional[Sequence[Any]] = None,
) -> Tuple[Dict[str, Any], List[float]]:
    """:meth:`Trainer.fit` over super-batches (:109-164): per epoch every
    chunk once, in random order, each through :meth:`Trainer.train_epoch`;
    the epoch loss is the mean of the chunks' losses weighted by their
    sizes. The stored ``neg_item_id`` column is not streamed when negatives
    are drawn in training. ``keys`` and ``negatives`` are
    :meth:`Trainer.train_epoch`'s seams, one per chunk in visit order over
    all epochs (the JAX package splits ``state["rng"]`` once per chunk,
    train/trainer.py:617); by default each chunk draws from the state's
    generator."""
    epochs = trainer.cfg.epochs if epochs is None else epochs
    feat = trainer.feature_tables(store)
    arrays = store.train_arrays()
    if trainer._in_step_negs:  # the step draws its own; do not stream the stored ones
        arrays = {k: v for k, v in arrays.items() if k != "neg_item_id"}
    stream = SuperBatchStream(arrays, superbatch_size, seed=seed, device=trainer.device)
    keys_it = None if keys is None else iter(keys)
    negs_it = None if negatives is None else iter(negatives)
    losses: List[float] = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        chunk_losses, sizes = [], []
        for chunk in stream.epoch():
            sizes.append(int(chunk["user_id"].shape[0]))
            state, loss = trainer.train_epoch(
                state, chunk, feat,
                keys=None if keys_it is None else next(keys_it),
                negatives=None if negs_it is None else next(negs_it),
            )
            chunk_losses.append(loss)
        # size-weighted: the trailing partial chunk counts for its share only
        mean_loss = float(np.average(torch.stack(chunk_losses).cpu().numpy(), weights=sizes))
        losses.append(mean_loss)
        if verbose:
            log.info("epoch %d: loss=%.5f (%.2fs, %d super-batches)", epoch, mean_loss,
                     time.perf_counter() - t0, stream.num_super)
    return state, losses

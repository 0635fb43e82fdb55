"""Multi-process entry points (port of ``torchrecsys_tpu/parallel/distributed.py``).

The JAX package runs a mesh either in one process over many devices or
multi-controller, one process per host (:1-33). The port takes the
torch idiom, which is the second model: one process per rank, every
rank running the same program, ``torch.distributed`` carrying the
collectives. Launch recipe (``torch.multiprocessing.spawn`` or
``torchrun`` starts the processes)::

    from torchrecsys_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed("tcp://host0:8476", num_processes=4, process_id=rank,
                     backend="nccl")   # one card per rank; "gloo" otherwise
    mesh = make_mesh(data=2, model=2)  # this rank's place in the mesh
    rs = RecSys(df, net_type="linear", mesh=mesh)

The backend is the caller's choice and is never guessed: ``"nccl"`` needs
a card of its own per rank (it refuses two ranks on one device);
``"gloo"`` runs anywhere, ranks sharing a card included, and the port's
collectives use only the two it carries on CUDA tensors, ``all_reduce``
and ``broadcast`` (parallel/mesh.py).

Data feeding: every rank may hold the full host array and take its
``data`` shard (:func:`make_global_array` full mode), or hold only its own
block of rows (local-rows mode, the rows of :func:`process_row_range`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from torchrecsys_tpu_torch.utils.logging import get_logger

log = get_logger("torchrecsys_tpu_torch.distributed")

BACKENDS = ("nccl", "gloo")


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str,
) -> None:
    """Join the process group (:42-66, over
    ``torch.distributed.init_process_group``). ``coordinator_address`` is
    ``"host:port"`` (TCP) or an init method URL (``tcp://...``,
    ``file://...``); ``backend`` is ``"nccl"`` or ``"gloo"``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    log.info("distributed initialized: process %d/%d over %s", process_id, num_processes, backend)


def process_row_range(n_rows: int, dim0_shards: int) -> tuple:
    """The [start, stop) block of dim 0 owned by THIS process when
    ``n_rows`` rows are split over ``dim0_shards`` shards laid out in
    process order (:74-101)."""
    pc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if dim0_shards % pc:
        raise ValueError(f"dim-0 shard count {dim0_shards} not divisible by {pc} processes")
    if n_rows % dim0_shards:
        raise ValueError(
            f"n_rows {n_rows} not divisible by dim-0 shard count "
            f"{dim0_shards}; pad the array to a multiple first"
        )
    rows_per_shard = n_rows // dim0_shards
    shards_per_proc = dim0_shards // pc
    start = pid * shards_per_proc * rows_per_shard
    return start, start + shards_per_proc * rows_per_shard


def make_global_array(host_data: np.ndarray, mesh, global_shape: Optional[tuple] = None) -> torch.Tensor:
    """This rank's ``data`` shard of a dim-0-split array, on the rank's
    device (:104-132). Full mode (``global_shape`` None or the host array's
    shape): every rank holds the whole array and takes rows ``[r n/d, (r+1)
    n/d)`` for its data rank r of d. Local-rows mode: ``host_data`` is
    already this rank's block of a ``global_shape`` array."""
    data = np.asarray(host_data)
    d = mesh.shape["data"]
    if global_shape is None or tuple(data.shape) == tuple(global_shape):
        n = data.shape[0]
        if n % d:
            raise ValueError(f"{n} rows do not split over data={d}; pad the array to a multiple first")
        rows = n // d
        block = data[mesh.data_rank * rows : (mesh.data_rank + 1) * rows]
    else:
        if global_shape[0] % d or data.shape[0] != global_shape[0] // d or data.shape[1:] != tuple(global_shape[1:]):
            raise ValueError(
                f"local rows {data.shape} are not one of data={d} blocks of {tuple(global_shape)}"
            )
        block = data
    return torch.as_tensor(np.ascontiguousarray(block), device=mesh.device)


def put_sharded(arrays: Dict[str, np.ndarray], mesh) -> Dict[str, torch.Tensor]:
    """A dict of host arrays, each as this rank's ``data`` shard on its
    device (:135-148)."""
    return {k: make_global_array(v, mesh) for k, v in arrays.items()}

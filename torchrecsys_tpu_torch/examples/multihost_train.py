"""Multi-process training launcher (port of ``examples/multihost_train.py``).

Run the SAME module in every rank's process, one process per rank:

    # rank 0
    python -m torchrecsys_tpu_torch.examples.multihost_train \\
        --coordinator host0:8476 --num-processes 2 --process-id 0 --backend nccl
    # rank 1
    python -m torchrecsys_tpu_torch.examples.multihost_train \\
        --coordinator host0:8476 --num-processes 2 --process-id 1 --backend nccl

``--backend`` is required with them: ``nccl`` needs a card per rank,
``gloo`` runs anywhere, ranks sharing a card included
(parallel/distributed.py). With no flags this is a world of one, ordinary
single-process training, so the module doubles as a single-card smoke
test.

What is multi-process-aware here without any further code:
- ``make_mesh()`` spans every rank of the world after ``init_distributed``;
- the trainer builds every batch alike on every rank and each rank trains
  its ``data`` slice of it (the Linear steps through the fused pairwise
  kernel's data-parallel mesh wrapper on the card);
- the streaming fit stages each chunk on every rank while the previous one
  trains.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.parallel import init_distributed, make_mesh
from torchrecsys_tpu_torch.train import Trainer


def synthetic(rows: int = 200_000) -> dict:
    """Every rank builds the identical dataset (seeded): the common recsys
    case where the interaction log fits host memory."""
    r = np.random.default_rng(0)
    return {
        "user_id": r.integers(0, 10_000, rows),
        "item_id": r.integers(0, 5_000, rows),
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Train and evaluate; rank 0 prints the losses and the eval."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None, help="host0:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the collectives' backend (required with --coordinator)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="size of the 'model' (table-row-sharding) mesh axis")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # join the world before building the mesh
    if args.coordinator or args.num_processes:
        if args.backend is None:
            ap.error("--backend is required with --coordinator/--num-processes")
        init_distributed(args.coordinator, args.num_processes, args.process_id, backend=args.backend)

    store = prepare_data(synthetic(args.rows), "user_id", "item_id", dynamic_neg_sampling=True)

    mesh = make_mesh(model=args.model_axis, device=args.device)
    model = build_model(store.schema, ModelConfig(net_type="linear", n_factors=64))
    trainer = Trainer(
        model, TrainConfig(batch_size=4096, learning_rate=0.05,
                           dynamic_neg_sampling=True), mesh=mesh,
    )
    state = trainer.init_state()
    # streaming fit: each chunk staged while the previous one trains
    state, losses = trainer.fit_streaming(
        state, store, superbatch_size=1 << 16, epochs=2
    )
    # evaluation sums each rank's rows over the mesh, so every rank takes part
    out = trainer.evaluate(state, store, verbose=False)
    if mesh.rank == 0:
        print("losses:", [round(l, 5) for l in losses])
        print("eval:", {k: round(v, 4) for k, v in out.items()})


if __name__ == "__main__":
    main()

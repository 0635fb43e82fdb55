"""The rank side of tests/test_torch_mesh_generic.py: one process per rank
of a 4-rank gloo world on the CPU, running the generic step's mesh cases
(every net, the configs the mesh wrappers do not take, the generic
scorer, the facade) on the mesh shapes each case names, and writing the
results for the test process to hold against the JAX package. Like
tests/_torch_mesh_ranks.py, this module imports torch and the port only,
never JAX.

The test process writes ``inputs.pt``: ``cases``, by name, each a dict
with its ``kind`` (a function below), the ``shapes`` it runs on and its
arguments (numpy arrays and plain objects). Rank r writes ``r{r}.pt``,
its results by shape and case.
"""

from __future__ import annotations

import copy
import hashlib
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tests._torch_mesh_ranks import _np, join  # noqa: F401  (join: the test process's)

SHAPES = ((4, 1), (2, 2), (1, 4))


def start(directory: str, world: int = 4):
    """Start ``world`` ranks that run every case on its shapes; they
    rendezvous through a file under ``directory``."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank, args=(world, directory), nprocs=world, join=False, start_method="spawn")


def _rank(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    from torchrecsys_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(f"file://{os.path.join(directory, 'rendezvous')}", world, rank, backend="gloo")
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        results = {}
        for shape in SHAPES:
            mesh = make_mesh(data=shape[0], model=shape[1], device="cpu")
            out = {"coords": (mesh.data_rank, mesh.model_rank)}
            for name, case in inputs["cases"].items():
                if shape in case["shapes"]:
                    where = os.path.join(directory, f"{name}-{shape[0]}x{shape[1]}")
                    out[name] = _np(KINDS[case["kind"]](mesh, case, where))
            out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "torchrecsys_tpu.")) for m in sys.modules)
            results[shape] = out
        torch.save(results, os.path.join(directory, f"r{rank}.pt"))
        dist.barrier()
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def digest(tree) -> str:
    """sha256 over every tensor of ``tree`` (names, shapes, bytes)."""
    h = hashlib.sha256()
    for name, t in _leaves(tree):
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _store(case):
    from torchrecsys_tpu_torch.data import prepare_data

    return prepare_data(case["data"], "user_id", "item_id", dynamic_neg_sampling=False, **case.get("data_kw", {}))


def _trainer(mesh, case):
    """The case's store, the port trainer on ``mesh`` and the JAX trainer's
    init state (carried over by the test process) sharded onto it."""
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.parallel import shard_state
    from torchrecsys_tpu_torch.train import Trainer

    store = _store(case)
    cfg = TrainConfig(**case["tcfg"])
    model = build_model(store.schema, ModelConfig(**case["mcfg"]))
    tr = Trainer(model, cfg, "cpu", mesh=mesh)
    return store, tr, shard_state(copy.deepcopy(case["state"]), mesh)


def _result(state, mesh, losses):
    """What the test compares: the whole state, the losses, and digests of
    what every replica must hold alike (this rank's table shards; the dense
    tree, its optimizer state and the running statistics)."""
    from torchrecsys_tpu_torch.parallel import gather_state

    whole = gather_state(state, mesh)
    acc = {k: v["acc"] for k, v in whole["emb_opt"].items() if "acc" in v}
    return {
        "losses": losses, "tables": whole["tables"], "acc": acc, "dense": whole["dense"],
        "model_state": whole["model_state"], "step": whole["step"],
        "tables_digest": digest({"t": state["tables"], "o": state["emb_opt"]}),
        "dense_digest": digest({"d": state["dense"], "m": state["model_state"],
                                "o": {k: v for k, v in (state["dense_opt"] or {}).items() if k != "count"}}),
    }


# ---------------------------------------------------------------------------
# kinds: each takes (mesh, case, directory) and returns what the test compares
# ---------------------------------------------------------------------------


def steps(mesh, case, where):
    """Autograd pairwise steps on this rank's rows of each batch (the
    augmented tables), the step losses summed over data."""
    from torchrecsys_tpu_torch.parallel.mesh import sum_shares
    from torchrecsys_tpu_torch.parallel.sharding import batch_rows
    from torchrecsys_tpu_torch.train.optim import augment_tables, split_augmented

    store, tr, state = _trainer(mesh, case)
    feat = tr.feature_tables(store)
    aug = augment_tables(state["tables"], state["emb_opt"])
    losses = []
    for users, pos, neg in case["batches"]:
        lo, hi = batch_rows(len(users), mesh)
        ids = [torch.as_tensor(a[lo:hi]) for a in (users, pos, neg)]
        loss = tr.pairwise_step(state, aug, *ids, None, None, feat)
        losses.append(float(sum_shares(loss, mesh, "data")))
    state["tables"], state["emb_opt"] = split_augmented(aug)
    return _result(state, mesh, losses)


def fit(mesh, case, where):
    """Epochs of Trainer.train_epoch with the JAX trainer's round keys and
    in-step draws; then evaluate."""
    store, tr, state = _trainer(mesh, case)
    data, feat = tr._device_train_data(store), tr.feature_tables(store)
    losses = []
    for keys, negs in zip(case["keys"], case["negs"]):
        state, loss = tr.train_epoch(state, data, feat, keys=torch.as_tensor(keys),
                                     negatives=None if negs is None else torch.as_tensor(negs))
        losses.append(float(loss))
    out = _result(state, mesh, losses)
    if case["evaluate"]:  # on the store's static test negatives
        out["eval"] = tr.evaluate(state, store, batch_size=case["tcfg"]["batch_size"], verbose=False)
    return out


def predict(mesh, case, where):
    """The generic scorer on the mesh (catalog_topk of the MLP): the
    users padded to data, the table rows through the sharded lookup."""
    from torchrecsys_tpu_torch.config import ModelConfig
    from torchrecsys_tpu_torch.eval.predict import catalog_topk
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.parallel import shard_state

    store = _store(case)
    model = build_model(store.schema, ModelConfig(**case["mcfg"]))
    state = shard_state(copy.deepcopy(case["state"]), mesh)
    params = {"tables": state["tables"], "dense": state["dense"]}
    users = torch.as_tensor(case["users"])
    vals, ids = catalog_topk(model, params, state["model_state"], users, store.schema.num_items, top_k=case["k"],
                             chunk_size=16, mesh=mesh)
    return {"vals": vals, "ids": ids}


def facade(mesh, case, where):
    """RecSys on the mesh: fit, a streamed epoch, evaluate, predict with
    and without exclude_seen, similar items where the net has item
    vectors, save (world rank 0 writes)."""
    from torchrecsys_tpu_torch import RecSys

    rs = RecSys(case["data"], mesh=mesh, seed=2, **case["rs"])
    out = {"losses": rs.fit(verbose=False, **case["fit"])}
    if case.get("stream"):
        state, out["stream_losses"] = rs.trainer.fit_streaming(rs.state, rs.store, superbatch_size=case["stream"],
                                                               epochs=1, verbose=False)
        rs._install(state)
    users = case["users"]
    out["pred"] = rs.predict(users, top_k=5)
    out["pred_seen"] = rs.predict(users, top_k=5, exclude_seen=True)
    out["eval"] = rs.evaluate(eval_metrics=case["metrics"], verbose=False)
    if case.get("similar") is not None:
        out["similar"] = rs.similar_items(case["similar"], top_k=5)
    if rs.ease is None:
        out["dense_digest"] = digest({"d": rs.state["dense"], "m": rs.state["model_state"]})
    rs.save(where)
    out["saved"] = where
    out["loaded_pred"] = RecSys.load(where, mesh=mesh).predict(users, top_k=5)  # re-sharded onto the mesh
    return out


KINDS = {"steps": steps, "fit": fit, "predict": predict, "facade": facade}

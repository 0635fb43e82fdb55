"""The rank side of tests/test_torch_parallel.py: one process per rank of a
4-rank gloo world on the CPU, running every mesh case of the port on each
mesh shape in turn (one world, a mesh per shape) and writing its results
for the test process to hold against the JAX package. This module imports
torch and the port only, never JAX: the ranks start from it
(``torch.multiprocessing.spawn`` imports the module of its target in
every child).

The test process writes ``inputs.pt`` (numpy arrays and plain objects)
into the run's directory; rank r writes ``r{r}.pt``, its results by
shape.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist


def start(shapes, directory: str, world: int = 4):
    """Start ``world`` ranks that run every case on each (data, model) mesh
    of ``shapes`` over one world; the ranks rendezvous through a file under
    ``directory``. Returns the processes' context for :func:`join`."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank, args=(world, [tuple(s) for s in shapes], directory), nprocs=world,
                              join=False, start_method="spawn")


def join(context) -> None:
    """Wait for every rank; raises if one failed."""
    while not context.join():
        pass


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # the message the test matches
        return f"{type(e).__name__}: {e}"
    return ""


def _rank(rank: int, world: int, shapes, directory: str) -> None:
    torch.set_num_threads(1)
    from torchrecsys_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(f"file://{os.path.join(directory, 'rendezvous')}", world, rank, backend="gloo")
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        results = {}
        for shape in shapes:
            mesh = make_mesh(data=shape[0], model=shape[1], device="cpu")
            inp = dict(inputs, dir=os.path.join(directory, f"mesh{shape[0]}x{shape[1]}"))
            out = {"mesh": {"shape": mesh.shape, "coords": (mesh.data_rank, mesh.model_rank)}}
            for name, case in CASES.items():
                out[name] = _np(case(mesh, inp))
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
# cases: each takes (mesh, inputs) and returns what the test compares
# ---------------------------------------------------------------------------


def case_layout(mesh, inp):
    from torchrecsys_tpu_torch.parallel import make_global_array, make_mesh, process_row_range, put_sharded

    x = inp["layout_x"]
    d = mesh.shape["data"]
    return {
        "rows": process_row_range(16, 4),
        "rows_error": _error(lambda: process_row_range(15, 4)),
        "shards_error": _error(lambda: process_row_range(16, 3)),
        "mesh_error": _error(lambda: make_mesh(data=3, device="cpu")),
        "model_error": _error(lambda: make_mesh(model=3, device="cpu")),
        "product_error": _error(lambda: make_mesh(data=2, model=3, device="cpu")),
        "put": put_sharded({"x": x}, mesh)["x"],
        "local": make_global_array(x[mesh.data_rank * (8 // d): (mesh.data_rank + 1) * (8 // d)], mesh,
                                   global_shape=x.shape),
    }


def _shard_rows(t, mesh, axis="model"):
    ax = mesh.axis(axis)
    rows = t.shape[0] // ax.size
    return torch.as_tensor(t[ax.index * rows: (ax.index + 1) * rows]).clone()


def case_embedding(mesh, inp):
    from torchrecsys_tpu_torch.parallel import all_gather, sharded_lookup, sharded_scatter_add

    table = _shard_rows(inp["emb_table"], mesh).requires_grad_()
    ids = torch.as_tensor(inp["emb_ids"])
    rows = sharded_lookup(table, ids, mesh)
    (grad,) = torch.autograd.grad((rows * torch.as_tensor(inp["emb_cot"])).sum(), [table])
    scat = sharded_scatter_add(table.detach().clone(), ids, torch.as_tensor(inp["emb_upd"]), mesh)
    return {"rows": rows, "grad": all_gather(grad, mesh, "model"), "scatter": all_gather(scat, mesh, "model")}


def _batch(x, mesh):
    from torchrecsys_tpu_torch.parallel.sharding import batch_rows

    lo, hi = batch_rows(x.shape[0], mesh)
    return torch.as_tensor(x[lo:hi]).contiguous()


def case_steps(mesh, inp):
    """B1-B4: one step of each variant from the same tables and ids."""
    from torchrecsys_tpu_torch.ops import fused_pairwise as fp
    from torchrecsys_tpu_torch.parallel import all_gather, psum

    tp = mesh.shape["model"] > 1
    out = {}
    for key, c in inp["steps"].items():
        user, item = _shard_rows(c["user"], mesh), _shard_rows(c["item"], mesh)
        ids = [_batch(c[k], mesh) for k in ("user_ids", "pos_ids", "neg_ids")]
        w = None if c["weights"] is None else _batch(c["weights"], mesh)
        kw = dict(d=c["d"], margin=1.0, loss_kind=c["loss"], sigmoid=c["sigmoid"], bf16=c["bf16"])
        if c["meta"] is None:
            step = fp.fused_pairwise_step_tp if tp else fp.fused_pairwise_step_dp
            _, _, loss = step(mesh, user, item, *ids, w, c["lr"], **kw)
            tables = {"user": user, "item": item}
        else:
            vec = [_shard_rows(t, mesh) for t in c["meta"]["vec"]]
            lin = None if c["meta"]["lin"] is None else [_shard_rows(t, mesh) for t in c["meta"]["lin"]]
            step = fp.fused_pairwise_step_meta_tp if tp else fp.fused_pairwise_step_meta_dp
            _, _, _, loss = step(mesh, user, item, vec, torch.as_tensor(c["meta"]["ids"]),
                                 torch.as_tensor(c["meta"]["mask"]), *ids, w, c["lr"],
                                 meta_lin=lin, fm=lin is not None, **kw)
            tables = {"user": user, "item": item, **{f"vec{i}": t for i, t in enumerate(vec)},
                      **{f"lin{i}": t for i, t in enumerate(lin or [])}}
        loss = psum(loss.reshape(1), mesh, "data")[0]  # the wrappers return this rank's share
        out[key] = {"loss": loss, **{k: all_gather(t, mesh, "model") for k, t in tables.items()}}
    out["launches"] = fp.pairwise_updates_rows.launches
    return out


def case_softmax(mesh, inp):
    """B5: this rank's rows of the in-batch CE and the gradients."""
    from torchrecsys_tpu_torch.ops.softmax_ce import inbatch_softmax_ce_dp
    from torchrecsys_tpu_torch.parallel import all_gather

    c = inp["softmax"]
    h, v, vbq = (_batch(c[k], mesh).requires_grad_() for k in ("h", "v", "vbq"))
    pos, g = _batch(c["pos"], mesh), _batch(c["g"], mesh)
    loss = inbatch_softmax_ce_dp(mesh, h, v, vbq, pos)
    dh, dv, dvb = torch.autograd.grad((loss * g).sum(), [h, v, vbq])
    return {k: all_gather(x.detach(), mesh, "data") for k, x in
            (("loss", loss), ("dh", dh), ("dv", dv), ("dvb", dvb))}


def _linear_store(inp):
    from torchrecsys_tpu_torch.data import prepare_data

    return prepare_data(inp["data"], "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])


def case_topk(mesh, inp):
    """B6: the model-sharded catalog top-k of Linear with metadata."""
    from torchrecsys_tpu_torch.config import ModelConfig
    from torchrecsys_tpu_torch.data.features import feature_tables
    from torchrecsys_tpu_torch.eval.predict import catalog_topk, ranking_eval
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.ops import dot_topk as dt
    from torchrecsys_tpu_torch.utils.convert import tables_from_jax

    store = _linear_store(inp)
    model = build_model(store.schema, ModelConfig(n_factors=8))
    tables = {k: _shard_rows(v, mesh) for k, v in tables_from_jax(inp["topk_tables"], model, "cpu").items()}
    params = {"tables": tables, "dense": {}}
    feat = feature_tables(store, model, "cpu")
    users = torch.as_tensor(inp["topk_users"])
    mask = torch.as_tensor(inp["topk_mask"])
    out = {}
    for k in inp["topk_ks"]:
        for masked in (False, True):
            v, i = catalog_topk(model, params, {}, users, store.schema.num_items, feat, top_k=k,
                                seen_mask=mask if masked else None, mesh=mesh)
            out[(k, masked)] = {"vals": v, "ids": i}
    out["ranking"] = ranking_eval(model, params, {}, store.test_users, store.test_items,
                                  store.schema.num_items, feat, ks=(5, 10), mesh=mesh)
    out["launches"] = dt.dot_topk_small.launches + dt.dot_topk_large.launches
    return out


def _mesh_trainer(mesh, data, loss, state_np):
    """Linear with metadata on ``data``, its trainer on the mesh and the
    JAX trainer's init ``state_np`` sharded onto it."""
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.parallel import shard_state
    from torchrecsys_tpu_torch.train import Trainer
    from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

    store = _linear_store({"data": data})
    model = build_model(store.schema, ModelConfig(n_factors=16))
    tr = Trainer(model, TrainConfig(batch_size=64, learning_rate=0.05, loss=loss, seed=3), "cpu", mesh=mesh)
    return store, tr, shard_state(train_state_from_jax(state_np, model, "cpu"), mesh)


def _fitted(state, mesh, losses):
    from torchrecsys_tpu_torch.parallel import gather_state

    whole = gather_state(state, mesh)
    return {"losses": losses, "tables": whole["tables"],
            "acc": {k: v["acc"] for k, v in whole["emb_opt"].items()}, "step": whole["step"],
            "local": state["tables"]}


def _fit(mesh, inp, loss):
    c = inp["fits"][loss]
    store, tr, state = _mesh_trainer(mesh, inp["data"], loss, c["state"])
    data, feat = tr._device_train_data(store), tr.feature_tables(store)
    losses = []
    for keys in c["keys"]:
        state, l = tr.train_epoch(state, data, feat, keys=torch.as_tensor(keys))
        losses.append(float(l))
    ev = tr.evaluate(state, store, batch_size=64, verbose=False, negatives=c.get("eval_negs"))
    return dict(_fitted(state, mesh, losses), eval=ev)


def case_fit_hinge(mesh, inp):
    return _fit(mesh, inp, "hinge")


def case_fit_softmax(mesh, inp):
    return _fit(mesh, inp, "sampled_softmax")


def case_fit_stream(mesh, inp):
    """Trainer.fit_streaming on the mesh: two epochs of super-batches (the
    trailing chunk does not split over data) with JAX's per-chunk keys."""
    c = inp["stream_fit"]
    store, tr, state = _mesh_trainer(mesh, c["data"], "hinge", c["state"])
    state, losses = tr.fit_streaming(state, store, superbatch_size=c["sb"], epochs=2, seed=5, verbose=False,
                                     keys=[torch.as_tensor(k) for k in c["keys"]])
    return _fitted(state, mesh, losses)


def case_stream(mesh, inp):
    from torchrecsys_tpu_torch.parallel import batch_sharding
    from torchrecsys_tpu_torch.train.streaming import SuperBatchStream

    stream = SuperBatchStream(inp["stream_arrays"], 100, seed=5, sharding=batch_sharding(mesh))
    epochs = []
    for _ in range(2):
        epochs.append([dict(c) for c in stream.epoch()])
    return epochs


def case_facade(mesh, inp):
    """RecSys on the mesh: a fit and a streamed epoch, save (gathered, rank 0 writes),
    predict and similar items; a single-device checkpoint loaded onto the
    mesh; and a fit at a batch that does not divide data."""
    from torchrecsys_tpu_torch import RecSys

    rs = RecSys(inp["data"], n_factors=8, net_type="fm", metadata_id_col=["cat"], mesh=mesh, seed=2)
    losses = rs.fit(epochs=2, batch_size=64, learning_rate=0.05, verbose=False)
    state, stream_losses = rs.trainer.fit_streaming(rs.state, rs.store, superbatch_size=128, epochs=1,
                                                    verbose=False)
    rs._install(state)  # what follows serves the streamed epoch's tables
    users = inp["facade_users"]
    out = {"losses": losses, "stream_losses": stream_losses, "pred": rs.predict(users, top_k=7, exclude_seen=True),
           "pred_plain": rs.predict(users, top_k=7),
           "similar": rs.similar_items(inp["facade_item"], top_k=5),
           "eval": rs.evaluate(eval_metrics=("loss", "auc", "recall@10"), verbose=False)}
    rs.save(os.path.join(inp["dir"], "mesh_ckpt"))
    loaded = RecSys.load(inp["single_ckpt"], mesh=mesh)
    out["loaded_pred"] = loaded.predict(users, top_k=7)
    extra = {"user_id": np.asarray([10**6, 10**6 + 1]), "item_id": np.asarray([10**6, inp["facade_item"]]),
             "cat": np.asarray([[1], [2]], dtype=object)}
    rs.update_data(extra)  # grown whole on every rank, then re-sharded
    out["grown_rows"] = {k: v.shape[0] * (mesh.shape["model"] if rs.mesh is not None else 1)
                         for k, v in rs.state["tables"].items()}
    out["grown_pred"] = rs.predict([10**6], top_k=3)
    b = mesh.shape["data"] * 16 + 1  # a batch that does not split over data
    out["odd_batch_losses"] = rs.fit(epochs=1, batch_size=b, verbose=False)
    return out


CASES = {
    "layout": case_layout,
    "embedding": case_embedding,
    "steps": case_steps,
    "softmax": case_softmax,
    "topk": case_topk,
    "fit_hinge": case_fit_hinge,
    "fit_softmax": case_fit_softmax,
    "fit_stream": case_fit_stream,
    "stream": case_stream,
    "facade": case_facade,
}

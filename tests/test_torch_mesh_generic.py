"""The generic step on a ('data', 'model') mesh (train/trainer.py: the
autograd steps on a rank's rows, the dense gradients and the MLP's
batch-norm statistics summed over ``data``, the uneven batch split;
eval/predict.py: the ``data``-sharded generic scorer; the facade with
every net) against the JAX package's ``Trainer(mesh=make_mesh(...))``
on the same mesh shape.

One module-scoped spawn of four gloo ranks on the CPU
(tests/_torch_mesh_generic_ranks.py, which imports no JAX) runs every
case on the mesh shapes it names, one world and a mesh per shape, the
ranks meeting through a file under the test's temporary directory. While
they run, the fixture computes the JAX references over
``jax.devices()[:4]`` at the same shapes, one thread per shape (XLA's
compiles are most of the time). Both packages start from the JAX
trainer's init state, with its round keys and its in-step draws.

Tolerances: JAX's own for sharded against single-device training
(tests/test_sharding.py:73-85: losses rtol 2e-4, tables atol 2e-5), the
AMP noise-floor rule of tests/test_torch_mlp.py for bf16 compute, exact
top-k ids. Every replica of the tables, the dense tree, its optimizer
state and the running statistics holds the same bits (sha256 per rank).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.eval import predict as jpred
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.parallel import batch_sharding as jbatch_sharding
from torchrecsys_tpu.parallel import make_mesh as jmake_mesh
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train.optim import augment_tables as jaugment
from torchrecsys_tpu.train.optim import split_augmented as jsplit
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests import _torch_mesh_generic_ranks as ranks
from tests.conftest import make_interactions
from tests.test_torch_lstm import seq_data
from tests.test_torch_mlp import _state_np
from tests.test_torch_pairwise_options import _jax_epoch_negs
from tests.test_torch_train import _data, _round_keys

LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6
TABLE_ATOL = 2e-5
SHAPES = list(ranks.SHAPES)
ALL = tuple(ranks.SHAPES)


def _jmesh(shape):
    return jmake_mesh(jax.devices()[:4], data=shape[0], model=shape[1])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(case, mesh=None):
    store = jprepare(case["data"], "user_id", "item_id", dynamic_neg_sampling=False, **case.get("data_kw", {}))
    return store, JTrainer(jbuild(store.schema, JModelConfig(**case["mcfg"])), JTrainConfig(**case["tcfg"]),
                           mesh=mesh)


def _carry(case, jax_state):
    """The JAX trainer's state (kept in the case as ``jax_state``, for the
    references here) carried over to the port as ``state``: torch tensors,
    which the ranks unpickle without importing JAX (optax's state classes
    would import it)."""
    store = prepare_data(case["data"], "user_id", "item_id", dynamic_neg_sampling=False, **case.get("data_kw", {}))
    model = build_model(store.schema, ModelConfig(**case["mcfg"]))
    case["jax_state"] = jax_state
    case["state"] = train_state_from_jax(jax_state, model, "cpu",
                                         dense_optimizer=TrainConfig(**case["tcfg"]).dense_optimizer)
    return case


# ---------------------------------------------------------------------------
# cases (inputs for the ranks) and their JAX references
# ---------------------------------------------------------------------------


def _mlp_step_cases():
    """The BN MLP of tests/test_sharding.py:49-84 (hidden (16, 8), n_factors
    8, batch 256), three steps from the JAX init on static negatives, the
    dense tree under sgd (its change is the gradient), in f32 and bf16."""
    data = make_interactions(n_users=64, n_items=48, n=2048)
    out = {}
    for compute in ("float32", "bfloat16"):
        case = dict(kind="steps", shapes=ALL, data=data,
                    mcfg=dict(net_type="mlp", n_factors=8, hidden_layers=(16, 8), use_batch_norm=True,
                              compute_dtype=compute),
                    tcfg=dict(batch_size=256, learning_rate=0.05, dense_optimizer="sgd", seed=3))
        jstore, jt = _jax(case)
        _carry(case, _state_np(jt.init_state(jax.random.PRNGKey(0))))
        r = np.random.default_rng(11)
        case["batches"] = [(jstore.train_users[i * 256:(i + 1) * 256], jstore.train_items[i * 256:(i + 1) * 256],
                            r.integers(0, jstore.schema.num_items, 256)) for i in range(3)]
        out[f"mlp_steps_{compute}"] = case
    return out


def _ref_steps(case, shape):
    jstore, jt = _jax(case, _jmesh(shape))
    js = jt.init_state(jax.random.PRNGKey(0))
    st = dict(js, tables=jaugment(js["tables"], js["emb_opt"]))
    feat = jt.feature_tables(jstore)
    step = jax.jit(lambda st, b, f: jt._step_impl(st, b, f, fused=True))
    losses = []
    for users, pos, neg in case["batches"]:
        batch = jax.device_put({"user_id": jnp.asarray(users, jnp.int32), "pos_item_id": jnp.asarray(pos, jnp.int32),
                                "neg_item_id": jnp.asarray(neg, jnp.int32)}, jbatch_sharding(jt.mesh))
        st, loss = step(st, batch, feat)
        losses.append(float(loss))
    tables, emb_opt = jsplit(st["tables"])
    return {"state": _state_np(dict(st, tables=tables, emb_opt=emb_opt)), "losses": losses}


def _fit_case(shapes, data, mcfg, tcfg, epochs=2, evaluate=True, data_kw=None):
    """A fit from the JAX init with JAX's round keys and, where it draws
    in training, its negatives of each epoch."""
    case = dict(kind="fit", shapes=shapes, data=data, mcfg=dict(n_factors=8, **mcfg),
                tcfg={"batch_size": 128, "learning_rate": 0.05, "seed": 3, "dense_optimizer": "adagrad", **tcfg},
                evaluate=evaluate, data_kw=data_kw or {})
    jstore, jt = _jax(case)
    js = jt.init_state(jax.random.PRNGKey(0))
    _carry(case, _state_np(js))
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    n = jstore.num_train
    nb = -(-n // min(jt.cfg.batch_size, n))
    rng, step, case["keys"], case["negs"] = js["rng"], 0, [], []
    for _ in range(epochs):
        case["keys"].append(_round_keys(rng).numpy())
        pairwise_draws = jt._in_step_negs and jt.cfg.loss != "sampled_softmax"
        draws = _jax_epoch_negs(jt, {"rng": rng, "step": step}, jdata, jfeat) if pairwise_draws else None
        case["negs"].append(None if draws is None else draws.numpy())
        rng, step = jax.random.split(rng)[0], step + nb
    return case


# each fit and the mesh shapes it runs on (JAX's epoch compiles are the
# cost: each case on one or two shapes)
FIT_SHAPES = {
    "lstm": ((2, 2),),
    "sasrec": ((2, 2),),
    "sasrec_softmax": ((2, 2),),
    "neucf": ((2, 2),),
    "mlp_fit": ((4, 1), (1, 4)),
    "linear_k2": ((4, 1),),
    "linear_warp": ((4, 1),),
    "linear_adaptive": ((2, 2),),
    "linear_sgd": ((2, 2),),
    "linear_unfused": ((1, 4),),
    "linear_b250": ((4, 1),),
}


def _fit_cases():
    seq = seq_data(n=400, n_users=40, n_items=50)
    lin = _data(False)
    hl = dict(history_len=5)
    at = FIT_SHAPES
    return {
        "lstm": _fit_case(at["lstm"], seq, dict(net_type="lstm", **hl), dict(batch_size=64)),
        "sasrec": _fit_case(at["sasrec"], seq, dict(net_type="sasrec", **hl), dict(batch_size=64)),
        "sasrec_softmax": _fit_case(at["sasrec_softmax"], seq, dict(net_type="sasrec", **hl),
                                    dict(batch_size=64, loss="sampled_softmax"), evaluate=False),
        "neucf": _fit_case(at["neucf"], _data(True), dict(net_type="neucf", neucf_hidden_layers=(16, 8)),
                           {}, epochs=1, data_kw={"metadata_id_col": ["cat"]}),
        "mlp_fit": _fit_case(at["mlp_fit"], lin, dict(net_type="mlp", hidden_layers=(16, 8)), {}, epochs=1),
        "linear_k2": _fit_case(at["linear_k2"], lin, {}, dict(num_negatives=2), evaluate=False),
        "linear_warp": _fit_case(at["linear_warp"], lin, {}, dict(loss="warp", num_negatives=4), epochs=1,
                                 evaluate=False),
        "linear_adaptive": _fit_case(at["linear_adaptive"], lin, {}, dict(loss="adaptive_hinge", num_negatives=2),
                                     epochs=1, evaluate=False),
        "linear_sgd": _fit_case(at["linear_sgd"], lin, {}, dict(embedding_optimizer="sgd")),
        "linear_unfused": _fit_case(at["linear_unfused"], lin, {}, dict(fused_embedding_update=False)),
        "linear_b250": _fit_case(at["linear_b250"], _data(False, n=1100), {}, dict(batch_size=250)),
    }


def _ref_fit(case, shape):
    jstore, jt = _jax(case, _jmesh(shape))
    js = jt.init_state(jax.random.PRNGKey(0))
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    losses = []
    for _ in case["keys"]:
        js, loss = jt._epoch_jit(js, jdata, jfeat)
        losses.append(float(loss))
    out = {"state": _state_np(js), "losses": losses}
    if case["evaluate"]:
        out["eval"] = jt.evaluate(js, jstore, batch_size=case["tcfg"]["batch_size"], verbose=False)
    return out


def _predict_case():
    """The generic scorer on 13 users (tests/test_sharding.py:261-276): the
    MLP's JAX init with running statistics away from (0, 1)."""
    case = dict(kind="predict", shapes=ALL, data=_data(False), k=5, users=np.arange(13),
                mcfg=dict(net_type="mlp", n_factors=8, hidden_layers=(16, 8)), tcfg={})
    _, jt = _jax(case)
    state = _state_np(jt.init_state(jax.random.PRNGKey(1)))
    g = np.random.default_rng(0)
    state["model_state"] = {"bn": [{"mean": g.normal(size=w).astype(np.float32) * 0.1,
                                    "var": g.uniform(0.5, 2.0, size=w).astype(np.float32)} for w in (16, 8)]}
    return _carry(case, state)


def _ref_predict(case, shape):
    jstore, jt = _jax(case)
    st = case["jax_state"]
    params = {"tables": jax.tree_util.tree_map(jnp.asarray, st["tables"]),
              "dense": jax.tree_util.tree_map(jnp.asarray, st["dense"])}
    vals, ids = jpred.catalog_topk(jt.model, params, jax.tree_util.tree_map(jnp.asarray, st["model_state"]),
                                   jnp.asarray(case["users"], jnp.int32), jstore.schema.num_items, top_k=case["k"],
                                   chunk_size=16, mesh=_jmesh(shape))
    return {"vals": np.asarray(vals), "ids": np.asarray(ids)}


def _facade_cases():
    """The MLP (dense adagrad: adam would turn the rounding of the hidden
    biases' zero gradient, which batch norm cancels, into lr-sized steps)
    and EASE through the facade on (2, 2)."""
    data = _data(True, n=600, n_users=30, n_items=60)
    base = dict(kind="facade", shapes=((2, 2),), data=data, users=list(range(6)))
    return {
        "mlp_facade": dict(base, rs=dict(net_type="mlp", n_factors=8, hidden_layers=(16, 8),
                                         metadata_id_col=["cat"]),
                           fit=dict(epochs=2, batch_size=64, learning_rate=0.05, optimizer="adagrad"), stream=128,
                           metrics=("loss", "auc", "recall@5"), similar=3),
        "ease_facade": dict(base, rs=dict(net_type="ease", ease_lam=2.0), fit={}, metrics=("recall@5",)),
    }


def _single_facade(case):
    """The facade case on one device (the port's, held against JAX by the
    single-device tests)."""
    rs = RecSys(case["data"], seed=2, device="cpu", **case["rs"])
    out = {"losses": rs.fit(verbose=False, **case["fit"])}
    if case.get("stream"):
        state, out["stream_losses"] = rs.trainer.fit_streaming(rs.state, rs.store, superbatch_size=case["stream"],
                                                               epochs=1, verbose=False)
        rs._install(state)
    out["pred"] = rs.predict(case["users"], top_k=5)
    out["pred_seen"] = rs.predict(case["users"], top_k=5, exclude_seen=True)
    out["eval"] = rs.evaluate(eval_metrics=case["metrics"], verbose=False)
    if case.get("similar") is not None:
        out["similar"] = rs.similar_items(case["similar"], top_k=5)
    return out


def _jax_references(cases):
    def on(shape):
        refs = {}
        for name, case in cases.items():
            if shape in case["shapes"]:
                ref = {"steps": _ref_steps, "fit": _ref_fit, "predict": _ref_predict}.get(case["kind"])
                if ref is not None:
                    refs[name] = ref(case, shape)
        return refs

    with ThreadPoolExecutor(len(SHAPES)) as pool:
        return dict(zip(SHAPES, pool.map(on, SHAPES)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_generic"))
    cases = {**_mlp_step_cases(), **_fit_cases(), "predict": _predict_case(), **_facade_cases()}
    torch.save({"cases": {n: {k: v for k, v in c.items() if k != "jax_state"} for n, c in cases.items()}},
               os.path.join(d, "inputs.pt"))
    running = ranks.start(d)
    try:
        refs = _jax_references(cases)
        singles = {name: _single_facade(c) for name, c in cases.items() if c["kind"] == "facade"}
    finally:
        ranks.join(running)
    results = [torch.load(os.path.join(d, f"r{i}.pt"), weights_only=False) for i in range(4)]
    return {"cases": cases, "refs": refs, "singles": singles, "results": results}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def run(request, inputs):
    """One mesh shape: the shape, the cases run there, their JAX
    references and the four ranks' results."""
    shape = request.param
    return shape, inputs, inputs["refs"][shape], [res[shape] for res in inputs["results"]]


def _cases_of(run, kind):
    shape, inp, refs, out = run
    names = [n for n, c in inp["cases"].items() if c["kind"] == kind and shape in c["shapes"]]
    return [(n, inp["cases"][n], refs.get(n), [res[n] for res in out]) for n in names]


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=msg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _assert_state(got, want, what):
    """Tables (atol 2e-5), accumulators, dense tree and running statistics
    against JAX's state."""
    for name, t in want["tables"].items():
        _close(got["tables"][name], t, 0, TABLE_ATOL, f"{what}: table {name}")
    for name, o in want["emb_opt"].items():
        if "acc" in o:
            _close(got["acc"][name], o["acc"], LOSS_RTOL, TABLE_ATOL, f"{what}: acc {name}")
    for (name, a), (_, b) in zip(_flat(got["dense"]), _flat(want["dense"])):
        _close(a, b, LOSS_RTOL, TABLE_ATOL, f"{what}: dense{name}")
    for (name, a), (_, b) in zip(_flat(got["model_state"]), _flat(want["model_state"])):
        _close(a, b, LOSS_RTOL, TABLE_ATOL, f"{what}: model_state{name}")


def _assert_replicas(shape, per_rank, what):
    """Every rank's dense tree, optimizer state and running statistics hold
    the same bits; so does every replica of a table shard (the ranks of one
    model column)."""
    assert len({r["dense_digest"] for r in per_rank}) == 1, what
    for rank, r in enumerate(per_rank):
        assert r["tables_digest"] == per_rank[rank % shape[1]]["tables_digest"], f"{what}: rank {rank}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_ranks_import_no_jax(run):
    shape, inp, refs, out = run
    for rank, res in enumerate(out):
        assert res["coords"] == divmod(rank, shape[1])
        assert not res["jax_imported"]


def test_mlp_steps_match_jax_on_the_mesh(run):
    """Three steps of the BN MLP in f32: losses, tables, the dense tree
    (sgd: its change is the summed gradient) and the running statistics
    of the global batch against JAX's GSPMD step on the same mesh."""
    shape = run[0]
    for name, case, ref, per_rank in _cases_of(run, "steps"):
        if "float32" not in name:
            continue
        for res in per_rank:
            _close(res["losses"], ref["losses"], LOSS_RTOL, LOSS_ATOL, f"{name} losses")
            _assert_state(res, ref["state"], name)
        _assert_replicas(shape, per_rank, name)


def test_amp_mlp_steps_within_the_noise_floor_of_jax(run):
    """bf16 compute: the port's fused tower (kernels #6/#7's plain versions
    here) with its sums reduced over data, against JAX's XLA bf16 tower on
    the mesh by the AMP rule of tests/test_torch_mlp.py: losses and running
    statistics within rtol 0.08; each parameter's change within max(1.5 x
    the distance between JAX's bf16 and f32 changes, 0.02)."""
    shape = run[0]
    steps = {n: (c, ref, per_rank) for n, c, ref, per_rank in _cases_of(run, "steps")}
    case, ref, per_rank = steps["mlp_steps_bfloat16"]
    f32_ref = steps["mlp_steps_float32"][1]
    before = case["state"]
    for res in per_rank:
        _close(res["losses"], ref["losses"], 0.08, 0, "losses")
        for (n, a), (_, b) in zip(_flat(res["model_state"]), _flat(ref["state"]["model_state"])):
            _close(a, b, 0.08, 1e-3, f"model_state{n}")
        for key in ("tables", "dense"):
            for (n, got), (_, jb), (_, jf), (_, b0) in zip(_flat(res[key]), _flat(ref["state"][key]),
                                                           _flat(f32_ref["state"][key]), _flat(before[key])):
                dp, dj, df = got - b0, jb - b0, jf - b0
                dist = np.linalg.norm(dp - dj) / max(np.linalg.norm(dj), 1e-12)
                floor = np.linalg.norm(dj - df) / max(np.linalg.norm(df), 1e-12)
                assert dist < max(1.5 * floor, 0.02), (key, n, dist, floor)
    _assert_replicas(shape, per_rank, "AMP MLP")


@pytest.mark.parametrize("name,shape", [(n, s) for n, shapes in FIT_SHAPES.items() for s in shapes],
                         ids=lambda x: x if isinstance(x, str) else f"mesh{x[0]}x{x[1]}")
def test_fits_match_jax_trainer_on_the_mesh(inputs, name, shape):
    """Epochs of every net and of the Linear configs the mesh wrappers do
    not take (K = 2 and 4 draws, WARP, adaptive hinge, sgd, the unfused
    update, a batch of 250 rows over data = 4), from the JAX init with its
    keys and draws, against JAX's Trainer on the same mesh: losses, state,
    evaluate on the store's static negatives; replicas bitwise equal."""
    case, ref = inputs["cases"][name], inputs["refs"][shape][name]
    if name == "linear_b250":
        assert case["tcfg"]["batch_size"] % shape[0]  # the uneven split
    per_rank = [res[shape][name] for res in inputs["results"]]
    for res in per_rank:
        _close(res["losses"], ref["losses"], LOSS_RTOL, LOSS_ATOL, f"{name} losses")
        assert res["step"] == int(ref["state"]["step"])
        _assert_state(res, ref["state"], name)
        if case["evaluate"]:
            _close(res["eval"]["loss"], ref["eval"]["loss"], LOSS_RTOL, LOSS_ATOL, f"{name} eval loss")
            _close(res["eval"]["auc"], ref["eval"]["auc"], 1e-6, 0, f"{name} eval auc")
    _assert_replicas(shape, per_rank, name)


def test_generic_predict_matches_jax_on_the_mesh(run):
    """The MLP's top-5 of 13 users (a count that does not divide data) on
    the mesh: ids identical to JAX's data-sharded scorer, scores within
    rtol 1e-5."""
    for name, case, ref, per_rank in _cases_of(run, "predict"):
        for res in per_rank:
            np.testing.assert_array_equal(res["ids"], ref["ids"])
            _close(res["vals"], ref["vals"], 1e-5, 1e-6, name)


@pytest.mark.parametrize("name", ["mlp_facade", "ease_facade"])
def test_facade_on_the_mesh_matches_one_device(inputs, name):
    """RecSys(net_type="mlp") on (2, 2): fit, a streamed epoch, evaluate,
    predict (exclude_seen over-fetches and filters on the host) and
    similar items against the same calls on one device; EASE fits whole
    on every rank and serves the single device's ids. Each checkpoint the
    mesh saved, loaded onto the mesh and cold without one, serves the
    mesh's ids."""
    case, single = inputs["cases"][name], inputs["singles"][name]
    (shape,) = case["shapes"]
    per_rank = [res[shape][name] for res in inputs["results"]]
    for res in per_rank:
        _close(res["losses"], single["losses"], LOSS_RTOL, LOSS_ATOL, f"{name} losses")
        if "stream_losses" in single:
            _close(res["stream_losses"], single["stream_losses"], LOSS_RTOL, LOSS_ATOL, f"{name} stream")
        for m, v in single["eval"].items():
            _close(res["eval"][m], v, LOSS_RTOL, LOSS_ATOL, f"{name} {m}")
        for key in ("pred", "pred_seen", "similar"):
            if key in single:
                np.testing.assert_array_equal(res[key], single[key], err_msg=f"{name} {key}")
    if "dense_digest" in per_rank[0]:
        assert len({r["dense_digest"] for r in per_rank}) == 1
    for res in per_rank:  # RecSys.load(mesh=) on every rank serves the mesh's ids
        np.testing.assert_array_equal(res["loaded_pred"], res["pred"])
    cold = RecSys.load(per_rank[0]["saved"], device="cpu")
    np.testing.assert_array_equal(cold.predict(case["users"], top_k=5), per_rank[0]["pred"])

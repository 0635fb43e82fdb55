"""The port on a ('data', 'model') mesh (torchrecsys_tpu_torch/parallel,
the mesh wrappers B1-B6, the mesh trainer, stream and facade) against the
JAX package on the same mesh shape.

One module-scoped spawn of four gloo ranks on the CPU
(tests/_torch_mesh_ranks.py, which imports no JAX) runs every case on
each mesh shape, (4, 1), (2, 2) and (1, 4), in turn, one world and a mesh
per shape (a spawn costs seconds of process start and imports); the
ranks rendezvous through a file under the test's temporary directory, so
parallel test workers share no port. While the ranks run, the fixture
computes every JAX reference here over ``jax.devices()[:4]`` (conftest
gives eight virtual CPU devices) at the same mesh shape, the kernels in
Pallas interpret mode, at tiny sizes (B = 64, N <= 256); the tests then
compare. Tolerances are
those of the single-device parity tests: rtol 1e-5 / atol 1e-6 for the
pairwise steps and fits, 2e-4 / 1e-6 for sampled softmax; ids, the
mesh's top-k values against the port on one device, and every all-gather
are exact.
"""

import copy
import functools
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
from torchrecsys_tpu.ops import fused_pairwise as jfp
from torchrecsys_tpu.ops import softmax_ce as jsce
from torchrecsys_tpu.parallel import batch_sharding as jbatch_sharding
from torchrecsys_tpu.parallel import make_mesh as jmake_mesh
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train.streaming import SuperBatchStream as JSuperBatchStream
from torchrecsys_tpu.train.trainer import _inbatch_softmax_rows
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.eval import predict as tpred
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import softmax_ce as tsce
from torchrecsys_tpu_torch.ops.dot_topk import pack_seen_mask
from torchrecsys_tpu_torch.parallel import Mesh, make_mesh
from torchrecsys_tpu_torch.train import Trainer

from tests import _torch_mesh_ranks as ranks
from tests.test_torch_evaluate import _jax_eval_negatives
from tests.test_torch_streaming import _jax_chunk_keys
from tests.test_torch_train import _state_np

RTOL, ATOL = 1e-5, 1e-6
SM_RTOL, SM_ATOL = 2e-4, 1e-6
SHAPES = [(4, 1), (2, 2), (1, 4)]
D = 8
B = 64
STREAM_SB = 128


def _data(n=600, n_users=40, n_items=200, seed=0):
    r = np.random.default_rng(seed)
    items = r.integers(0, n_items, n)
    return {"user_id": r.integers(0, n_users, n), "item_id": items,
            "cat": np.asarray([[int(i % 5)] + ([int(i % 3) + 5] if i % 2 else []) for i in items], dtype=object)}


def _jmesh(shape):
    return jmake_mesh(jax.devices()[:4], data=shape[0], model=shape[1])


# ---------------------------------------------------------------------------
# inputs: one set for every mesh shape
# ---------------------------------------------------------------------------


def _packed(r, rows, d=D):
    t = np.zeros((rows, 128), np.float32)
    t[:, :d] = r.normal(size=(rows, d)) * 0.3
    t[:, d] = np.abs(r.normal(size=rows)) * 0.1
    t[:, d + 1] = r.normal(size=rows) * 0.1
    t[:, d + 2] = np.abs(r.normal(size=rows)) * 0.1
    return t


def _step_inputs():
    r = np.random.default_rng(7)
    user, item = _packed(r, 128), _packed(r, 256)
    uid = np.sort(r.integers(0, 128, B))
    uid[:6] = uid[0]  # a user on several rows of every shard's batch
    pid, nid = r.integers(0, 256, B), r.integers(0, 256, B)
    pid[::9] = 17  # an item that is many rows' positive and negative
    nid[::11] = 17
    w = (np.arange(B) % 7 != 3).astype(np.float32)
    vec = r.normal(size=(64, D + 1)).astype(np.float32) * 0.3
    vec[:, D] = np.abs(vec[:, D])
    lin = np.stack([r.normal(size=64) * 0.1, np.abs(r.normal(size=64)) * 0.1], 1).astype(np.float32)
    meta = {"vec": [vec], "ids": r.integers(0, 64, (256, 1, 2)), "mask": r.random((256, 1, 2)) < 0.7}
    base = dict(user=user, item=item, user_ids=uid, pos_ids=pid, neg_ids=nid, d=D, lr=0.05)
    cases = {
        "linear hinge": dict(loss="hinge", sigmoid=False, weights=None, bf16=False, meta=None),
        "linear bpr weighted": dict(loss="bpr", sigmoid=False, weights=w, bf16=False, meta=None),
        "fm logistic sigmoid": dict(loss="logistic", sigmoid=True, weights=None, bf16=False, meta=None),
        "linear hinge bf16": dict(loss="hinge", sigmoid=False, weights=None, bf16=True, meta=None),
        "linear meta bpr weighted": dict(loss="bpr", sigmoid=False, weights=w, bf16=False,
                                         meta=dict(meta, lin=None)),
        "fm meta hinge": dict(loss="hinge", sigmoid=True, weights=None, bf16=False, meta=dict(meta, lin=[lin])),
        "fm meta logistic bf16 weighted": dict(loss="logistic", sigmoid=False, weights=w, bf16=True,
                                               meta=dict(meta, lin=[lin])),
    }
    return {k: dict(base, **c) for k, c in cases.items()}


def _jax_trainer(data, loss, mesh=None):
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    return jstore, JTrainer(jbuild(jstore.schema, JModelConfig(n_factors=16)),
                            JTrainConfig(batch_size=B, learning_rate=0.05, loss=loss, seed=3), mesh=mesh)


def _jax_state_and_keys(loss):
    """The JAX trainer's init (Linear with metadata) and the round keys of
    two epochs (the epoch splits state["rng"] once, trainer.py:617)."""
    jstore, jt = _jax_trainer(_data(), loss)
    jstate = jt.init_state(jax.random.PRNGKey(0))
    rng, keys = jstate["rng"], []
    for _ in range(2):
        rng, k = jax.random.split(rng)
        keys.append(np.asarray(jax.random.randint(k, (6,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32),
                               np.int64))
    out = {"state": _state_np(jstate), "keys": keys}
    if loss == "sampled_softmax":
        out["eval_negs"] = _jax_eval_negatives(jt, dict(jstate, rng=rng), jstore, B)
    return out


def _stream_fit_inputs():
    """The streamed fit's split (481 train rows: chunks of STREAM_SB rows that
    split over data and a trailing 97 that do not), the JAX trainer's init
    and its per-chunk round keys over two epochs."""
    data = _data(n=601)
    jstore, jt = _jax_trainer(data, "hinge")
    jstate = jt.init_state(jax.random.PRNGKey(0))
    assert jstore.num_train % STREAM_SB % 2 == 1
    keys = _jax_chunk_keys(jstate["rng"], 2 * -(-jstore.num_train // STREAM_SB))
    return {"data": data, "sb": STREAM_SB, "state": _state_np(jstate), "keys": [k.numpy() for k in keys]}


def _single_facade(data, d):
    """The facade's single-device run that the mesh facade is held against:
    two epochs, one streamed epoch, evaluate, save, predict, update_data."""
    single = RecSys(data, n_factors=D, net_type="fm", metadata_id_col=["cat"], seed=2, device="cpu")
    out = {"losses": single.fit(epochs=2, batch_size=B, learning_rate=0.05, verbose=False)}
    state, out["stream_losses"] = single.trainer.fit_streaming(single.state, single.store, superbatch_size=128,
                                                               epochs=1, verbose=False)
    single._install(state)
    out["eval"] = single.evaluate(eval_metrics=("loss", "auc", "recall@10"), verbose=False)
    single.save(os.path.join(d, "single_ckpt"))
    out["users"] = [int(u) for u in single.store.user_encoder.to_list()[:6]]
    out["item"] = int(single.store.item_encoder.to_list()[3])
    out["pred"] = single.predict(out["users"], top_k=7)
    single.update_data(_extra(out["item"]))
    out["grown_rows"] = {k: v.shape[0] for k, v in single.state["tables"].items()}
    # the mesh facade's last fit, at batch data x 16 + 1, from the grown state
    out["odd_batch_losses"] = {d: copy.deepcopy(single).fit(epochs=1, batch_size=d * 16 + 1, verbose=False)
                               for d in (4, 2, 1)}
    return out


def _extra(item):
    return {"user_id": np.asarray([10**6, 10**6 + 1]), "item_id": np.asarray([10**6, item]),
            "cat": np.asarray([[1], [2]], dtype=object)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_inputs"))
    r = np.random.default_rng(3)
    data = _data()
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    jmodel = jbuild(jstore.schema, JModelConfig(n_factors=D))
    tables = {k: np.asarray(v) for k, v in jmodel.init(jax.random.PRNGKey(5))[0]["tables"].items()}
    single = _single_facade(data, d)
    for shape in SHAPES:
        os.makedirs(os.path.join(d, f"mesh{shape[0]}x{shape[1]}"))
    inp = {
        "dir": d,
        "single_ckpt": os.path.join(d, "single_ckpt"),
        "data": data,
        "layout_x": np.arange(24, dtype=np.float32).reshape(8, 3),
        "emb_table": r.normal(size=(128, 4)).astype(np.float32),
        "emb_ids": np.asarray([0, 5, 31, 32, 33, 64, 95, 96, 127, 5, 64, 64]),
        "emb_cot": r.normal(size=(12, 4)).astype(np.float32),
        "emb_upd": r.normal(size=(12, 4)).astype(np.float32),
        "steps": _step_inputs(),
        "softmax": {"h": r.normal(size=(B, D)).astype(np.float32), "v": r.normal(size=(B, D)).astype(np.float32),
                    "vbq": r.normal(size=B).astype(np.float32), "pos": r.integers(0, 12, B),
                    "g": (r.random(B) / B).astype(np.float32)},
        "topk_tables": tables,
        "topk_users": np.arange(16),
        "topk_mask": pack_seen_mask([r.choice(200, 30, replace=False) for _ in range(16)], 200),
        "topk_ks": (10, 100),
        "fits": {loss: _jax_state_and_keys(loss) for loss in ("hinge", "sampled_softmax")},
        "stream_fit": _stream_fit_inputs(),
        "stream_arrays": {"x": np.arange(1003, dtype=np.int32), "y": np.arange(1003, dtype=np.int32) * 3},
        "facade_users": single["users"],
        "facade_item": single["item"],
        "single": single,
    }
    torch.save(inp, os.path.join(d, "inputs.pt"))
    running = ranks.start(SHAPES, d)
    try:
        inp["refs"] = _jax_references(inp)  # JAX's compiles take as long as the ranks
    finally:
        ranks.join(running)
    inp["results"] = [torch.load(os.path.join(d, f"r{i}.pt"), weights_only=False) for i in range(4)]
    return inp


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def run(request, inputs):
    """Every case on one mesh shape: the shape, the inputs (``dir`` the
    shape's directory, ``ref`` the JAX references on the shape) and the
    four ranks' results."""
    shape = request.param
    inp = dict(inputs, dir=os.path.join(inputs["dir"], f"mesh{shape[0]}x{shape[1]}"), ref=inputs["refs"][shape])
    return shape, inp, [res[shape] for res in inputs["results"]]


def _jax_rows(u, p, n, weights, inv, lr, *, d, margin, loss_kind, sigmoid, eps, interpret,
              emit_g=False, item_upd=True, bf16=False):
    """The row math of ``_pairwise_kernel`` (:149-243) in plain jnp, with
    ``_pairwise_updates_rows``' contract: what the JAX mesh wrappers run
    here in place of the kernel, whose Pallas interpret mode inside
    ``shard_map`` takes tens of seconds per call on the CPU. The kernel's
    row math itself is held against the port's in
    tests/test_torch_fused_pairwise.py."""
    del interpret
    f32 = jnp.float32
    col = jnp.arange(128)[None, :]
    vmask = (col < d).astype(f32)
    rnd = (lambda x: x.astype(jnp.bfloat16).astype(f32)) if bf16 else (lambda x: x)
    uv, pv, nv = rnd(u * vmask), rnd(p * vmask), rnd(n * vmask)
    lane = lambda a, c: a[:, c:c + 1]
    raw_p = jnp.sum(uv * pv, 1, keepdims=True) + rnd(lane(u, d + 1)) + rnd(lane(p, d + 1))
    raw_n = jnp.sum(uv * nv, 1, keepdims=True) + rnd(lane(u, d + 1)) + rnd(lane(n, d + 1))
    s_p, s_n = (jax.nn.sigmoid(raw_p), jax.nn.sigmoid(raw_n)) if sigmoid else (raw_p, raw_n)
    if loss_kind == "hinge":
        diff = s_n - s_p + margin
        l = jnp.maximum(diff, 0.0)
        act = (diff > 0).astype(f32) + 0.5 * (diff == 0).astype(f32)
        dp, dn = -act, act
    elif loss_kind == "bpr":
        l = jax.nn.softplus(s_n - s_p)
        sg = jax.nn.sigmoid(s_n - s_p)
        dp, dn = -sg, sg
    else:
        l = -0.5 * (-jax.nn.softplus(-s_p) - jax.nn.softplus(s_n))
        dp, dn = -0.5 * jax.nn.sigmoid(-s_p), 0.5 * jax.nn.sigmoid(s_n)
    if sigmoid:
        dp, dn = dp * s_p * (1 - s_p), dn * s_n * (1 - s_n)
    w = jnp.ones((u.shape[0], 1), f32) if weights is None else weights.astype(f32)[:, None]
    gp, gn = dp * (w * inv), dn * (w * inv)
    loss_sum = jnp.sum(l * w)
    inv_d = np.float32(1.0 / d)

    def upd(gvec, acc, gb, bacc):
        msq = jnp.sum(gvec * gvec, 1, keepdims=True) * inv_d
        out = -lr * (gvec * jax.lax.rsqrt(acc + msq + eps))
        out = out + jnp.where(col == d, msq, 0.0)
        out = out + jnp.where(col == d + 1, -lr * (gb * jax.lax.rsqrt(bacc + gb * gb + eps)), 0.0)
        return out + jnp.where(col == d + 2, gb * gb, 0.0)

    uo = upd(gp * pv + gn * nv, lane(u, d), gp + gn, lane(u, d + 2))
    if emit_g:
        uo = uo + jnp.where(col == d + 4, gp, 0.0) + jnp.where(col == d + 5, gn, 0.0)
    if not item_upd:
        return uo, None, None, loss_sum
    return (uo, upd(gp * uv, lane(p, d), gp, lane(p, d + 2)), upd(gn * uv, lane(n, d), gn, lane(n, d + 2)),
            loss_sum)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_embedding(shape, inp):
    from torchrecsys_tpu.parallel.embedding import sharded_lookup, sharded_scatter_add

    jmesh = _jmesh(shape)
    jids = jnp.asarray(inp["emb_ids"], jnp.int32)

    @jax.jit
    def ref(t):
        rows, vjp = jax.vjp(lambda t: sharded_lookup(t, jids, jmesh), t)
        return rows, vjp(jnp.asarray(inp["emb_cot"]))[0], sharded_scatter_add(t, jids, jnp.asarray(inp["emb_upd"]),
                                                                               jmesh)

    return _np(ref(jnp.asarray(inp["emb_table"])))


def _ref_steps(shape, inp):
    """JAX's ``_dp``/``_tp`` wrappers (their row math in jnp, :func:`_jax_rows`)
    on each step case: every case at (4, 1), each at one of (2, 2) and (1, 4)."""
    jmesh = _jmesh(shape)
    tp = shape[1] > 1
    out = {}
    for j, (key, c) in enumerate(inp["steps"].items()):
        if tp and (j % 2) != (shape[1] == 4):  # B2/B4: each case on one of the two row-sharded meshes
            continue
        ids = [jnp.asarray(c[k], jnp.int32) for k in ("user_ids", "pos_ids", "neg_ids")]
        w = None if c["weights"] is None else jnp.asarray(c["weights"])
        kw = dict(d=D, margin=1.0, loss_kind=c["loss"], sigmoid=c["sigmoid"], bf16=c["bf16"], interpret=True)
        if c["meta"] is None:
            fn = jfp.fused_pairwise_step_tp if tp else jfp.fused_pairwise_step_dp
            ju, ji, jl = jax.jit(functools.partial(fn, jmesh, **kw))(
                jnp.asarray(c["user"]), jnp.asarray(c["item"]), *ids, w, c["lr"])
            want = {"user": ju, "item": ji}
        else:
            m = c["meta"]
            lin = None if m["lin"] is None else tuple(jnp.asarray(t) for t in m["lin"])
            fn = jfp.fused_pairwise_step_meta_tp if tp else jfp.fused_pairwise_step_meta_dp
            ju, ji, jv, jlin, jl = jax.jit(functools.partial(fn, jmesh, fm=lin is not None, **kw))(
                jnp.asarray(c["user"]), jnp.asarray(c["item"]), tuple(jnp.asarray(t) for t in m["vec"]),
                lin, jnp.asarray(m["ids"], jnp.int32), jnp.asarray(m["mask"]), *ids, w, c["lr"])
            want = {"user": ju, "item": ji, "vec0": jv[0], **({"lin0": jlin[0]} if lin is not None else {})}
        out[key] = _np(dict(want, loss=jl))
    return out


def _ref_softmax(inp):
    """The JAX package's in-batch CE of the whole batch and its gradients
    (``_inbatch_softmax_rows``, what its ``inbatch_softmax_ce_dp`` equals)."""
    c = inp["softmax"]
    h, v, vbq, g = (jnp.asarray(c[k]) for k in ("h", "v", "vbq", "g"))
    pos = jnp.asarray(c["pos"], jnp.int32)

    @jax.jit
    def ref(h, v, vbq):
        loss, vjp = jax.vjp(lambda h, v, vbq: _inbatch_softmax_rows(h, v, vbq, pos, None), h, v, vbq)
        return loss, vjp(g)

    loss, (dh, dv, dvb) = ref(h, v, vbq)
    return _np({"loss": loss, "dh": dh, "dv": dv, "dvb": dvb})


def _ref_topk(shape, inp):
    """JAX's sharded scorer on two of the four (k, mask) cases (compiles are
    slow), and ``ranking_eval`` on the mesh."""
    jmesh = _jmesh(shape)
    jstore = jprepare(inp["data"], "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    jmodel = jbuild(jstore.schema, JModelConfig(n_factors=D))
    jfeat = JTrainer(jmodel, JTrainConfig()).feature_tables(jstore)
    jparams = {"tables": {k: jnp.asarray(v) for k, v in inp["topk_tables"].items()}, "dense": {}}
    users, n = jnp.asarray(inp["topk_users"], jnp.int32), jstore.schema.num_items
    out = {}
    for k, masked in ((inp["topk_ks"][0], False), (inp["topk_ks"][-1], True)):
        mask = jnp.asarray(inp["topk_mask"]) if masked else None
        out[(k, masked)] = _np(jpred._sharded_catalog_topk(jmodel, jparams, users, n, jfeat, k, jmesh,
                                                           seen_mask=mask))
    out["ranking"] = jpred.ranking_eval(jmodel, jparams, {}, jstore.test_users, jstore.test_items, n, jfeat,
                                        ks=(5, 10), mesh=jmesh)
    return out


def _ref_fit(shape, loss):
    """JAX's Trainer on the mesh: two epochs of Linear with metadata, then
    evaluate."""
    jstore, jt = _jax_trainer(_data(), loss, _jmesh(shape))
    jstate = jt.init_state(jax.random.PRNGKey(0))
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    losses = []
    for _ in range(2):
        jstate, jl = jt._epoch_jit(jstate, jdata, jfeat)
        losses.append(float(jl))
    return {"state": _np(jstate), "losses": losses, "eval": jt.evaluate(jstate, jstore, batch_size=B, verbose=False)}


def _ref_fit_stream(shape, inp):
    """JAX's fit_streaming on the mesh (its sharded stream; the trailing
    chunk replicated), two epochs."""
    c = inp["stream_fit"]
    jstore, jt = _jax_trainer(c["data"], "hinge", _jmesh(shape))
    jstate, losses = jt.fit_streaming(jt.init_state(jax.random.PRNGKey(0)), jstore, superbatch_size=c["sb"],
                                      epochs=2, seed=5, verbose=False)
    return {"state": _np(jstate), "losses": losses}


def _ref_stream(shape, inp):
    """JAX's sharded stream over two epochs: each chunk's shard on the
    device at each rank's mesh coordinates."""
    jmesh = _jmesh(shape)
    jstream = JSuperBatchStream(inp["stream_arrays"], 100, seed=5, sharding=jbatch_sharding(jmesh))
    devices = np.asarray(jmesh.devices).reshape(-1)  # rank order: (data, model) row-major
    epochs = []
    for _ in range(2):
        chunks = list(jstream.epoch())
        epochs.append([[{k: np.asarray(next(s for s in w[k].addressable_shards if s.device == dev).data)
                         for k in w} for w in chunks] for dev in devices])
    return epochs


def _jax_references(inp):
    """Every JAX reference of the mesh tests, by mesh shape (``"softmax"``
    is the same on every shape)."""
    softmax = _ref_softmax(inp)

    def on(shape):
        return {
            "embedding": _ref_embedding(shape, inp),
            "steps": _ref_steps(shape, inp),
            "topk": _ref_topk(shape, inp),
            "fits": {loss: _ref_fit(shape, loss) for loss in ("hinge", "sampled_softmax")},
            "fit_stream": _ref_fit_stream(shape, inp),
            "stream": _ref_stream(shape, inp),
            "softmax": softmax,
        }

    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(SHAPES)) as pool:
        mp.setattr(jfp, "_pairwise_updates_rows", _jax_rows)
        return dict(zip(SHAPES, pool.map(on, SHAPES)))  # XLA compiles in parallel


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the parallel layer
# ---------------------------------------------------------------------------


def test_mesh_layout_and_feeding(run):
    shape, inp, out = run
    x = inp["layout_x"]
    for rank, res in enumerate(out):
        di, mi = divmod(rank, shape[1])
        assert res["mesh"] == {"shape": {"data": shape[0], "model": shape[1]}, "coords": (di, mi)}
        assert not res["jax_imported"]
        lay = res["layout"]
        assert lay["rows"] == (rank * 4, rank * 4 + 4)
        assert "not divisible by dim-0 shard count" in lay["rows_error"]
        assert "not divisible by 4 processes" in lay["shards_error"]
        assert lay["mesh_error"] == "ValueError: 4 devices not divisible by data=3"
        assert lay["model_error"] == "ValueError: 4 devices not divisible by model=3"
        assert lay["product_error"] == "ValueError: data*model = 2*3 != 4 devices"
        rows = 8 // shape[0]
        np.testing.assert_array_equal(lay["put"], x[di * rows: (di + 1) * rows])
        np.testing.assert_array_equal(lay["local"], x[di * rows: (di + 1) * rows])


def test_sharded_lookup_scatter_and_gradient(run):
    shape, inp, out = run
    want_rows, want_grad, want_scat = inp["ref"]["embedding"]
    for res in out:
        e = res["embedding"]
        np.testing.assert_array_equal(e["rows"], want_rows)  # exact: one non-zero term per row
        _close(e["grad"], want_grad)
        _close(e["scatter"], want_scat)


# ---------------------------------------------------------------------------
# B1-B5
# ---------------------------------------------------------------------------


def test_mesh_steps_match_jax_wrappers(run):
    """One step of B1/B2 (Linear and FM rows, weights, bf16) and B3/B4
    (Linear and FM metadata) from the same tables and ids, against JAX's
    ``_dp``/``_tp`` wrappers on the same mesh (:func:`_ref_steps`); the
    ranks' loss shares summed over data."""
    shape, inp, out = run
    for key, want in inp["ref"]["steps"].items():
        for rank, res in enumerate(out):
            got = res["steps"][key]
            for name, t in want.items():
                _close(got[name], t, msg=f"{key} {name}, rank {rank}")
            # every replica of a table holds the same bits
            np.testing.assert_array_equal(got["item"], out[0]["steps"][key]["item"])
    for res in out:  # one row-level launch per step on each rank (on the CPU its plain version)
        assert res["steps"]["launches"] == 0


def test_mesh_softmax_matches_jax(run):
    """B5: each rank's rows against the all-gathered batch; loss, dh, dv,
    dvb against the JAX package's in-batch CE of the whole batch
    (:func:`_ref_softmax`; the rectangular kernel contract is held against
    ``_ce`` below)."""
    shape, inp, out = run
    for res in out:
        for name, want in inp["ref"]["softmax"].items():
            _close(res["softmax"][name], want, SM_RTOL, SM_ATOL, msg=name)


def test_rectangular_ce_matches_jax():
    """The rectangular contract of #4/#5 (rows against columns, the label
    at r + off) in the port's plain versions against JAX's ``_ce`` (one
    data shard of four: the last row block), and the square call as its
    off=0 case."""
    off = 192
    r = np.random.default_rng(off)
    br, bc = 64, 256
    h = r.normal(size=(br, D)).astype(np.float32)
    v = r.normal(size=(bc, D)).astype(np.float32)
    vbq = r.normal(size=bc).astype(np.float32)
    pos_col = r.integers(0, 9, bc)
    pos = pos_col[off: off + br]
    g = r.random(br).astype(np.float32)
    args = (jnp.asarray(h), jnp.asarray(v), jnp.asarray(vbq), jnp.asarray(pos, jnp.int32),
            jnp.asarray(pos_col, jnp.int32), jnp.asarray(off, jnp.int32))
    jloss, jlse = jsce._call_fwd(*args, True)
    jgrads = jax.grad(lambda h, v, vbq: jnp.sum(jsce._ce(h, v, vbq, *args[3:], True) * g),
                      argnums=(0, 1, 2))(*args[:3])
    t = [torch.from_numpy(x) for x in (h, v, vbq, pos, pos_col)]
    loss, lse = tsce.softmax_ce_fwd(*t[:4], pos_col=t[4], off=off)
    _close(loss.numpy(), np.asarray(jloss), SM_RTOL, SM_ATOL)
    _close(lse.numpy(), np.asarray(jlse)[:, 0], SM_RTOL, SM_ATOL)
    grads = tsce.softmax_ce_bwd(*t[:4], lse, torch.from_numpy(g), pos_col=t[4], off=off)
    for got, want in zip(grads, jgrads):
        _close(got.numpy(), np.asarray(want), SM_RTOL, SM_ATOL)
    hs, vs = (torch.from_numpy(x) for x in (r.normal(size=(bc, D)).astype(np.float32),) * 2)
    sq = tsce.softmax_ce_fwd(hs, vs, t[2], t[4])
    rect = tsce.softmax_ce_fwd(hs, vs, t[2], t[4], pos_col=t[4], off=0)
    assert all(torch.equal(a, b) for a, b in zip(sq, rect))
    with pytest.raises(ValueError, match="off="):
        tsce.softmax_ce_fwd(*t[:4], pos_col=t[4], off=bc - br + 1)


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------


def test_sharded_topk_matches_jax_and_one_device(run):
    """B6 at k within and past a shard (100 > 64 rows at (1, 4)), with and
    without a seen mask: ids against JAX's sharded scorer on the same mesh,
    ids and values bit for bit against the port's single-device call; the
    ranking metrics through it."""
    shape, inp, out = run
    ref = inp["ref"]["topk"]
    tstore = prepare_data(inp["data"], "user_id", "item_id", dynamic_neg_sampling=False, metadata_id_col=["cat"])
    tmodel = build_model(tstore.schema, ModelConfig(n_factors=D))
    from torchrecsys_tpu_torch.data.features import feature_tables
    from torchrecsys_tpu_torch.utils.convert import tables_from_jax

    tparams = {"tables": tables_from_jax(inp["topk_tables"], tmodel, "cpu"), "dense": {}}
    tfeat = feature_tables(tstore, tmodel, "cpu")
    users = inp["topk_users"]
    n = tstore.schema.num_items
    for k in inp["topk_ks"]:
        for masked in (False, True):
            mask = inp["topk_mask"] if masked else None
            tv, ti = tpred.catalog_topk(tmodel, tparams, {}, torch.from_numpy(users), n, tfeat, top_k=k,
                                        seen_mask=None if mask is None else torch.from_numpy(mask))
            for rank, res in enumerate(out):
                got = res["topk"][(k, masked)]
                np.testing.assert_array_equal(got["ids"], ti.numpy(), err_msg=f"k={k} rank {rank}")
                np.testing.assert_array_equal(got["vals"], tv.numpy())
                if (k, masked) in ref:  # two of the four against JAX
                    jv, ji = ref[(k, masked)]
                    np.testing.assert_array_equal(got["ids"], ji, err_msg=f"k={k} rank {rank}")
                    _close(got["vals"], jv)
    want = ref["ranking"]
    for res in out:
        assert res["topk"]["ranking"].keys() == want.keys()
        for m in want:
            assert res["topk"]["ranking"][m] == pytest.approx(want[m], rel=1e-12), m


# ---------------------------------------------------------------------------
# the mesh trainer, stream and facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_two_epoch_fits_match_jax_trainer_on_the_mesh(run, loss):
    """Linear with metadata, two epochs from the JAX trainer's init with
    its round keys (static negatives; the softmax draws none), against JAX's
    Trainer on the same mesh: losses, tables, accumulators, evaluate."""
    shape, inp, out = run
    ref = inp["ref"]["fits"][loss]
    jstate, jlosses, jeval = ref["state"], ref["losses"], ref["eval"]
    rtol, atol = (RTOL, ATOL) if loss == "hinge" else (SM_RTOL, SM_ATOL)
    key = "fit_hinge" if loss == "hinge" else "fit_softmax"
    for rank, res in enumerate(out):
        f = res[key]
        _close(f["losses"], jlosses, rtol, atol)
        assert f["step"] == int(jstate["step"])
        for name in jstate["tables"]:
            _close(f["tables"][name], np.asarray(jstate["tables"][name]), rtol, atol, msg=f"table {name}")
            _close(f["acc"][name], np.asarray(jstate["emb_opt"][name]["acc"]), rtol, atol, msg=f"acc {name}")
            # replicas (ranks of one model column) hold the same bits
            np.testing.assert_array_equal(f["local"][name], out[rank % shape[1]][key]["local"][name])
        _close(f["eval"]["loss"], jeval["loss"], rtol, atol)
        _close(f["eval"]["auc"], jeval["auc"], 1e-6, 0)


def test_streamed_fit_matches_jax_fit_streaming_on_the_mesh(run):
    """Trainer.fit_streaming on the mesh, two epochs of super-batches with
    JAX's per-chunk keys, against JAX's fit_streaming on the same mesh (its
    sharded stream; the trailing chunk replicated): losses, tables,
    accumulators, step; replicas bit for bit."""
    shape, inp, out = run
    jstate, jlosses = inp["ref"]["fit_stream"]["state"], inp["ref"]["fit_stream"]["losses"]
    for rank, res in enumerate(out):
        f = res["fit_stream"]
        _close(f["losses"], jlosses)
        assert f["step"] == int(jstate["step"])
        for name in jstate["tables"]:
            _close(f["tables"][name], np.asarray(jstate["tables"][name]), msg=f"table {name}")
            _close(f["acc"][name], np.asarray(jstate["emb_opt"][name]["acc"]), msg=f"acc {name}")
            np.testing.assert_array_equal(f["local"][name], out[rank % shape[1]]["fit_stream"]["local"][name])


def test_sharded_stream_matches_jax_shards(run):
    """Each rank's chunk is its data shard of JAX's chunk on the device at
    its mesh coordinates; the trailing 3-row chunk that does not split over
    data comes whole (replicated), as in JAX."""
    shape, inp, out = run
    for epoch, want in enumerate(inp["ref"]["stream"]):
        for rank, res in enumerate(out):
            got = res["stream"][epoch]
            assert len(got) == len(want[rank]) == 11
            for chunk, w in zip(got, want[rank]):
                for k in ("x", "y"):
                    np.testing.assert_array_equal(chunk[k], w[k])


def test_facade_on_the_mesh_saves_loads_and_serves(run):
    """RecSys(df, net_type="fm", mesh=...): fit, a streamed epoch, predict,
    similar items, evaluate; ``save`` on the mesh read back by a cold
    ``RecSys.load`` without one serves the same ids; a single-device
    checkpoint loaded onto the mesh serves the single device's ids;
    ``update_data`` grows the sharded state as one device grows its own."""
    shape, inp, out = run
    f0, single = out[0]["facade"], inp["single"]
    _close(f0["losses"], single["losses"])
    _close(f0["stream_losses"], single["stream_losses"])
    for m, v in single["eval"].items():  # after the streamed epoch
        _close(f0["eval"][m], v, RTOL, ATOL, msg=m)
    for res in out:
        f = res["facade"]
        np.testing.assert_array_equal(f["pred"], f0["pred"])
        np.testing.assert_array_equal(f["similar"], f0["similar"])
        np.testing.assert_array_equal(f["loaded_pred"], single["pred"])
        # a batch that does not divide data (item 14b) trains as on one device
        _close(f["odd_batch_losses"], single["odd_batch_losses"][shape[0]], 2e-4, ATOL)
    assert f0["grown_rows"] == single["grown_rows"]
    assert f0["grown_pred"].shape == (1, 3)
    cold = RecSys.load(os.path.join(inp["dir"], "mesh_ckpt"), device="cpu")
    assert cold.state["tables"]["item"].shape[0] == single["grown_rows"]["item"]
    np.testing.assert_array_equal(cold.predict(inp["facade_users"], top_k=7), f0["pred_plain"])


# ---------------------------------------------------------------------------
# item 14b (the generic step, now ported), and the mesh argument
# ---------------------------------------------------------------------------


def test_what_the_generic_step_would_run_raises_naming_item_14b():
    """What raised naming item 14b now runs: on a one-rank CPU mesh every
    net fits and serves, and every trainer config the mesh wrappers do not
    take trains, exactly as without a mesh; the generic scorer serves the
    same ids. Objects that are not a Mesh still raise TypeError."""
    mesh = make_mesh(device="cpu")  # a world of one rank
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 1}
    data = _data()
    users = [int(u) for u in np.unique(data["user_id"])[:3]]
    for net in ("mlp", "neucf", "lstm", "sasrec", "ease"):
        runs = []
        for m in (None, mesh):
            rs = RecSys(data, n_factors=D, net_type=net, mesh=m, device="cpu", history_len=4, hidden_layers=(8, 4))
            runs.append((rs.fit(epochs=1, batch_size=B, verbose=False), rs.predict(users, top_k=4)))
        assert runs[0][0] == runs[1][0], net
        np.testing.assert_array_equal(runs[0][1], runs[1][1], err_msg=net)
    store = prepare_data(data, "user_id", "item_id")
    model = build_model(store.schema, ModelConfig(n_factors=D))
    for kw in (dict(num_negatives=2), dict(loss="warp"), dict(loss="adaptive_hinge"),
               dict(embedding_optimizer="sgd"), dict(fused_embedding_update=False),
               dict(loss="sampled_softmax", embedding_optimizer="sgd")):
        runs = []
        for m in (None, mesh):
            tr = Trainer(model, TrainConfig(batch_size=B, **kw), device="cpu", mesh=m)
            state, losses = tr.fit(tr.init_state(), store, epochs=1, verbose=False)
            runs.append((losses, state["tables"]))
        assert runs[0][0] == runs[1][0], kw
        for name, t in runs[0][1].items():
            assert torch.equal(t, runs[1][1][name]), (kw, name)
    mlp = build_model(store.schema, ModelConfig(net_type="mlp", n_factors=D, hidden_layers=(8, 4)))
    params, mstate = mlp.init(torch.Generator().manual_seed(0))
    got = [tpred.catalog_topk(mlp, params, mstate, torch.arange(3), store.schema.num_items, use_fused=False,
                              mesh=m) for m in (None, mesh)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Mesh"):
        Trainer(model, TrainConfig(), device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        RecSys.load("ckpt/", mesh=object(), device="cpu")


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_init_distributed_takes_no_guessed_backend():
    from torchrecsys_tpu_torch.parallel import init_distributed

    with pytest.raises(ValueError, match="backend"):
        init_distributed("localhost:1", 1, 0, backend="mpi")
    with pytest.raises(ValueError, match="process_id"):
        init_distributed("localhost:1", 2, 2, backend="gloo")

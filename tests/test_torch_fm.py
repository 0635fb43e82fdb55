"""FM on the port (models/fm.py; FM's metadata step in
ops/fused_pairwise.py; FM training, evaluation and serving through
``RecSys(net_type="fm")``) against the JAX package's ``FMModel``.

Inputs are made with numpy from a seed; tables are the JAX package's,
carried over with ``torchrecsys_tpu_torch/utils/convert.py``. f32 results
are held within rtol=1e-5, atol=1e-6 (f32 sums in another order; XLA's CPU
rsqrt is an approximation where torch's is 1/sqrt); bf16 compute within
rtol=2e-2 (bf16 rounds at other places in XLA and in torch). The JAX side
runs its Pallas kernel #3 in interpret mode (``interpret=True``,
``pallas_step=True``), as its own tests do, or its XLA step
(``pallas_step=False``). The CUDA kernels run only on a card: the ``gpu``
tests at the end hold the card's FM fits against the CPU's there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import DataSchema as JDataSchema
from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.eval import predict as jpred
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.ops import fused_pairwise as jfp
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import DataSchema, ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.eval import predict as tpred
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.models.base import padded_rows
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils.convert import tables_from_jax, train_state_from_jax

from tests.test_torch_train import _data, _round_keys, _state_np

RTOL, ATOL = 1e-5, 1e-6
D = 16
N_USERS, N_ITEMS = 30, 25
VOCABS, W = (9, 7), 3  # two metadata features of three slots


# ---------------------------------------------------------------------------
# the model: score_rows, pair_vectors, linearized_catalog
# ---------------------------------------------------------------------------


def _models(meta: bool, sigmoid: bool, amp: bool):
    names = ("genre", "tag") if meta else ()
    schema = dict(num_users=N_USERS, num_items=N_ITEMS, metadata_names=names,
                  metadata_vocab_sizes=VOCABS[: len(names)], metadata_width=W if meta else 0)
    mcfg = dict(net_type="fm", n_factors=D, fm_sigmoid=sigmoid,
                compute_dtype="bfloat16" if amp else "float32")
    return jbuild(JDataSchema(**schema), JModelConfig(**mcfg)), build_model(DataSchema(**schema), ModelConfig(**mcfg))


def _model_inputs(jmodel, seed: int, b: int = 40):
    """Tables (the JAX layout) for every table spec, a batch and the item
    feature table: F=2, W=3; item 0 fully masked; items 3 and 4 share a
    metadata id (in different slots)."""
    r = np.random.default_rng(seed)
    tables = {
        name: (r.normal(size=(padded_rows(spec.rows), spec.dim)) * 0.4).astype(np.float32)
        for name, spec in jmodel.table_specs().items()
    }
    feat = {}
    if jmodel.schema.metadata_names:
        mids = np.stack([r.integers(0, v, (N_ITEMS, W)) for v in VOCABS], axis=1)
        mmask = r.random((N_ITEMS, len(VOCABS), W)) < 0.7
        mmask[0] = False
        mids[3, 0, 0] = mids[4, 0, 2] = 5
        mmask[3, 0, 0] = mmask[4, 0, 2] = True
        feat = {"meta_ids": mids, "meta_mask": mmask}
    batch = {"user_id": r.integers(0, N_USERS, b), "item_id": r.integers(0, N_ITEMS, b)}
    batch["item_id"][:4] = [0, 3, 4, 0]
    if feat:
        batch["meta_ids"] = feat["meta_ids"][batch["item_id"]]
        batch["meta_mask"] = feat["meta_mask"][batch["item_id"]]
    return tables, batch, feat


def _to_jax(d):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in d.items()}


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _close(got, want, amp, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if amp:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max(), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sigmoid", [True, False], ids=["sigmoid", "raw"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_model_matches_jax_fm(meta, sigmoid, amp):
    """score_rows, pair_vectors (fm_sigmoid=False; refused with it) and
    linearized_catalog (item vectors and biases, user vectors and
    constants, the transform) against JAX's FMModel on the same tables."""
    jmodel, tmodel = _models(meta, sigmoid, amp)
    tables, batch, feat = _model_inputs(jmodel, seed=3 + meta)
    jrows = jmodel.gather_rows(_to_jax(tables), _to_jax(batch))
    trows = tmodel.gather_rows(_to_torch(tables), _to_torch(batch))
    assert set(trows) == set(jrows)
    jb, tb = _to_jax(batch), _to_torch(batch)
    want, _ = jmodel.score_rows({}, {}, jrows, jb, False)
    got, _ = tmodel.score_rows({}, {}, trows, tb, False)
    assert got.dtype == torch.float32
    _close(got, want, amp, "score_rows")
    if sigmoid:
        with pytest.raises(ValueError, match="fm_sigmoid=False"):
            tmodel.pair_vectors({}, {}, trows, tb, train=False)
    else:
        jv = jmodel.pair_vectors({}, {}, jrows, jb, False)
        tv = tmodel.pair_vectors({}, {}, trows, tb, train=False)
        for name, g, x in zip(("h", "v", "vb"), tv[:3], jv[:3]):
            assert g.dtype == (torch.bfloat16 if amp else torch.float32), name
            _close(g, x, amp, f"pair_vectors {name}")
    jq, jib, juser_fn, jtransform = jmodel.linearized_catalog({"tables": _to_jax(tables)}, _to_jax(feat))
    tq, tib, tuser_fn, ttransform = tmodel.linearized_catalog({"tables": _to_torch(tables)}, _to_torch(feat))
    assert tq.dtype == (torch.bfloat16 if amp else torch.float32)
    _close(tq, jq, amp, "catalog q")
    _close(tib, jib, False, "catalog item bias")  # f32 from the f32 tables
    users = np.arange(N_USERS)
    ju, jc = juser_fn({"tables": _to_jax(tables)}, jnp.asarray(users, jnp.int32))
    tu, tc = tuser_fn({"tables": _to_torch(tables)}, torch.from_numpy(users))
    _close(tu, ju, amp, "user vectors")
    _close(tc, jc, False, "user constants")
    raw = np.random.default_rng(1).normal(size=(N_USERS, 7)).astype(np.float32)
    _close(ttransform(torch.from_numpy(raw), tc), jtransform(jnp.asarray(raw), jc), False, "transform")
    # the collapse is the model's score: catalog score == score_rows per (user, item)
    if not amp:
        full = (tu @ tq.T + tib[None, :])
        side = {"user_id": torch.from_numpy(users).repeat_interleave(N_ITEMS),
                "item_id": torch.arange(N_ITEMS).repeat(N_USERS)}
        if feat:
            side["meta_ids"] = torch.from_numpy(feat["meta_ids"])[side["item_id"]]
            side["meta_mask"] = torch.from_numpy(feat["meta_mask"])[side["item_id"]]
        direct, _ = tmodel.score({"tables": _to_torch(tables), "dense": {}}, {}, side)
        torch.testing.assert_close(ttransform(full, tc).reshape(-1), direct, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# FM's metadata step (plain version) against JAX's fused_pairwise_step_meta
# ---------------------------------------------------------------------------


def _step_tables(seed, n_users=N_USERS, n_items=N_ITEMS):
    """Packed user/item tables, two augmented (rows, D+1) metadata tables
    and their augmented (rows, 2) linear tables, (n_items, 2, 3) ids and
    masks: item 0 fully masked, a metadata id shared by items 3 and 4."""
    r = np.random.default_rng(seed)
    user, item = (np.zeros((k, 128), np.float32) for k in (n_users, n_items))
    for t in (user, item):
        t[:, :D] = r.normal(size=(t.shape[0], D)) * 0.3
        t[:, D] = np.abs(r.normal(size=t.shape[0])) * 0.1
        t[:, D + 1] = r.normal(size=t.shape[0]) * 0.1
        t[:, D + 2] = np.abs(r.normal(size=t.shape[0])) * 0.1
    vec, lin = [], []
    for rows in VOCABS:
        v = (r.normal(size=(rows, D + 1)) * 0.3).astype(np.float32)
        v[:, D] = np.abs(v[:, D])
        a = (r.normal(size=(rows, 2)) * 0.1).astype(np.float32)
        a[:, 1] = np.abs(a[:, 1])
        vec.append(v)
        lin.append(a)
    mids = np.stack([r.integers(0, v, (n_items, W)) for v in VOCABS], axis=1)
    mmask = r.random((n_items, len(VOCABS), W)) < 0.7
    mmask[0] = False
    mids[3, 0, 0] = mids[4, 0, 1] = 5
    mmask[3, 0, 0] = mmask[4, 0, 1] = True
    return user, item, vec, lin, mids, mmask


def _step_ids(b, seed, dups: bool):
    r = np.random.default_rng(seed)
    if not dups:  # every id once; positives 0 (fully masked), 3 and 4 (a shared metadata id)
        items = np.concatenate([[0, 3, 4], r.permutation(np.setdiff1d(np.arange(N_ITEMS), [0, 3, 4]))])
        return r.permutation(N_USERS)[:b], items[:b], items[b : 2 * b]
    uid, pid, nid = r.integers(0, N_USERS, b), r.integers(0, N_ITEMS, b), r.integers(0, N_ITEMS, b)
    pid[0], nid[1], pid[2], nid[2] = 0, 0, 3, 4  # the fully masked item; the shared metadata id
    uid[:6] = uid[0]  # a user on 6 rows, an item both a row's positive and its negative, and another's
    nid[3] = pid[3]
    nid[7] = pid[9]
    return uid, pid, nid


def _jax_fm_step(tables, ids, w, lr, **kw):
    user, item, vec, lin, mids, mmask = tables
    out = jfp.fused_pairwise_step_meta(
        jnp.asarray(user), jnp.asarray(item), tuple(map(jnp.asarray, vec)), tuple(map(jnp.asarray, lin)),
        jnp.asarray(mids, jnp.int32), jnp.asarray(mmask), *(jnp.asarray(x, jnp.int32) for x in ids),
        None if w is None else jnp.asarray(w), lr, fm=True, interpret=True, **kw,
    )
    nu, ni, nmv, nml, loss = out
    return [np.asarray(nu), np.asarray(ni)] + [np.asarray(t) for t in nmv] + [np.asarray(t) for t in nml], \
        float(loss)


def _port_fm_step(tables, ids, w, lr, step=tfp.fused_pairwise_step_meta, **kw):
    user, item, vec, lin, mids, mmask = tables
    tu, ti = torch.from_numpy(user.copy()), torch.from_numpy(item.copy())
    tv = [torch.from_numpy(v.copy()) for v in vec]
    tl = [torch.from_numpy(v.copy()) for v in lin]
    *_, loss = step(tu, ti, tv, torch.from_numpy(mids), torch.from_numpy(mmask),
                    *(torch.from_numpy(x) for x in ids), None if w is None else torch.from_numpy(w), lr,
                    meta_lin=tl, fm=True, **kw)
    return [tu.numpy(), ti.numpy()] + [t.numpy() for t in tv] + [t.numpy() for t in tl], float(loss)


@pytest.mark.parametrize("dups", [False, True], ids=["distinct", "duplicates"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
def test_fm_meta_step_matches_pallas(loss, weighted, dups):
    """fused_pairwise_step_meta(fm=True) (on the CPU its plain version)
    against JAX's with the kernel in interpret mode, with FM's sigmoid:
    every table (user, item, both metadata tables and both linear-metadata
    tables) and the loss. Distinct ids: rtol=1e-5, atol=1e-6. With
    duplicate ids the scatter adds in another order: within 1e-5 of the
    table's largest entry as well."""
    tables = _step_tables(21)
    b = 9 if not dups else 30
    ids = _step_ids(b, 22, dups)
    w = (np.arange(b) < b - 3).astype(np.float32) if weighted else None
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=True)
    got, gl = _port_fm_step(tables, ids, w, 0.05, **kw)
    want, wl = _jax_fm_step(tables, ids, w, 0.05, **kw)
    names = ["user", "item", "meta0", "meta1", "linear_meta0", "linear_meta1"]
    for name, g, x in zip(names, got, want):
        atol = ATOL + (1e-5 * np.abs(x).max() if dups else 0.0)
        np.testing.assert_allclose(g, x, rtol=RTOL, atol=atol, err_msg=name)
    np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)
    # every table moved where an id names it
    for name, g, x in zip(names, got, (tables[0], tables[1], *tables[2], *tables[3])):
        assert not np.array_equal(g, x), name


@pytest.mark.parametrize("sigmoid", [True, False], ids=["sigmoid", "raw"])
def test_fm_meta_step_bf16_matches_pallas(sigmoid):
    """AMP's rounding chain on every FM path (:750-752) at the JAX
    package's AMP tolerance, rtol=2e-2, atol=2e-3."""
    tables = _step_tables(23)
    ids = _step_ids(30, 24, True)
    w = (np.arange(30) < 26).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=sigmoid, bf16=True)
    got, gl = _port_fm_step(tables, ids, w, 0.05, **kw)
    want, wl = _jax_fm_step(tables, ids, w, 0.05, **kw)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(gl, wl, rtol=2e-2, atol=2e-3)


def test_fm_meta_step_plain_twin_and_checks():
    """The wrapper on CPU tables is its plain twin, bit for bit; meta_lin
    goes with fm=True only and is checked like the other tables; the
    Linear step keeps its signature and never reads meta_lin."""
    tables = _step_tables(25)
    ids = _step_ids(30, 26, True)
    kw = dict(d=D, margin=1.0, loss_kind="bpr", sigmoid=True)
    a, la = _port_fm_step(tables, ids, None, 0.05, **kw)
    b, lb = _port_fm_step(tables, ids, None, 0.05, step=tfp.fused_pairwise_step_meta_plain, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert la == lb
    user, item, vec, lin, mids, mmask = tables
    args = (torch.from_numpy(user.copy()), torch.from_numpy(item.copy()), [torch.from_numpy(v) for v in vec],
            torch.from_numpy(mids), torch.from_numpy(mmask), *(torch.from_numpy(x) for x in ids), None, 0.05)
    with pytest.raises(ValueError, match="meta_lin goes with fm=True"):
        tfp.fused_pairwise_step_meta(*args, fm=True, **kw)
    with pytest.raises(ValueError, match="meta_lin goes with fm=True"):
        tfp.fused_pairwise_step_meta(*args, meta_lin=[torch.from_numpy(v) for v in lin], **kw)
    with pytest.raises(ValueError, match="meta_lin"):
        tfp.fused_pairwise_step_meta(*args, meta_lin=[torch.from_numpy(lin[0])], fm=True, **kw)
    with pytest.raises(ValueError, match="meta_lin"):
        tfp.fused_pairwise_step_meta(*args, meta_lin=[torch.zeros((9, 3)), torch.zeros((7, 2))], fm=True,
                                     **kw)


@pytest.mark.parametrize("loss", ["hinge", "bpr"])
def test_fm_step_without_metadata_is_the_sigmoid_step(loss):
    """FM without metadata rides fused_pairwise_step with sigmoid=True: its
    pack puts the linear terms in the bias lanes (models/fm.py:38-42)."""
    user, item, *_ = _step_tables(27)
    ids = _step_ids(30, 28, True)
    w = (np.arange(30) < 27).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=True)
    jids = tuple(jnp.asarray(x, jnp.int32) for x in ids)
    ju, ji, jl = jfp.fused_pairwise_step(jnp.asarray(user), jnp.asarray(item), *jids, jnp.asarray(w), 0.05,
                                         interpret=True, **kw)
    tu, ti, tl = tfp.fused_pairwise_step(torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
                                         *(torch.from_numpy(x) for x in ids), torch.from_numpy(w), 0.05, **kw)
    atol = ATOL + 1e-5 * np.abs(np.asarray(ji)).max()  # duplicate ids: another scatter order
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=atol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=atol)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# FM training against the JAX Trainer
# ---------------------------------------------------------------------------


def _fm_trainers(meta, loss, pallas_step, amp=False, sigmoid=True, net="fm"):
    data = _data(meta)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    mcfg = dict(net_type=net, n_factors=D, fm_sigmoid=sigmoid, compute_dtype="bfloat16" if amp else "float32")
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)), JTrainConfig(
        batch_size=128, learning_rate=0.05, loss=loss, seed=3, pallas_step=pallas_step))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)),
                 TrainConfig(batch_size=128, learning_rate=0.05, loss=loss, seed=3), "cpu")
    assert jt._pallas_pairwise() == pallas_step and tt._fused
    return jstore, tstore, jt, tt


def _two_epochs(jstore, tstore, jt, tt):
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    assert tstore.num_train % 128 != 0  # the weighted remainder batch is exercised
    losses = []
    for _ in range(2):
        keys = _round_keys(jstate["rng"])
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys)
        losses.append((float(tloss), float(jloss)))
    assert tstate["step"] == int(jstate["step"])
    return jstate, tstate, losses


@pytest.mark.parametrize("pallas_step", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("loss", ["hinge", "bpr"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_fm_two_epochs_match_jax_trainer(meta, loss, pallas_step):
    """Two epochs of FM (fm_sigmoid=True, the default) from the JAX init
    with the JAX round keys and static negatives: every table (the
    width-1 linear tables and, with metadata, meta_cat and linear_meta_cat
    included), every accumulator and the epoch losses within rtol=1e-5,
    atol=1e-6, as the JAX package holds its own two paths
    (tests/test_fused_pairwise.py:49-75, :116-143)."""
    jstore, tstore, jt, tt = _fm_trainers(meta, loss, pallas_step)
    jstate, tstate, losses = _two_epochs(jstore, tstore, jt, tt)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    want_tables = {"user", "item", "linear_user", "linear_item"} | (
        {"meta_cat", "linear_meta_cat"} if meta else set())
    assert set(jstate["tables"]) == want_tables == set(tstate["tables"])
    for name in jstate["tables"]:
        np.testing.assert_allclose(tstate["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"table {name}")
        np.testing.assert_allclose(tstate["emb_opt"][name]["acc"].numpy(),
                                   np.asarray(jstate["emb_opt"][name]["acc"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"acc {name}")


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_fm_pack_state_round_trip(meta):
    """FM's pack: user/linear_user and item/linear_item into (rows, 128);
    the augmented (Rf, D+1) metadata and (Rf, 2) linear-metadata tables
    stay outside it; unpack gives back every table and accumulator."""
    _, tstore, _, tt = _fm_trainers(meta, "hinge", False)
    state = tt.init_state()
    packed = tt.pack_state(state)
    want = {"user", "item"} | ({"meta_cat", "linear_meta_cat"} if meta else set())
    assert set(packed) == want
    if meta:
        assert packed["linear_meta_cat"].shape[1] == 2 and packed["meta_cat"].shape[1] == D + 1
    out = tt.unpack_state(state, packed, 0)
    for name, t in state["tables"].items():
        assert torch.equal(out["tables"][name], t), name
        assert torch.equal(out["emb_opt"][name]["acc"], state["emb_opt"][name]["acc"]), name


def test_fm_wider_than_the_lanes_takes_the_autograd_step():
    """FM wider than the kernel's lanes (n_factors > 122 with metadata, >
    124 without) trains through the autograd pairwise step on score_rows."""
    store = prepare_data(_data(True), "user_id", "item_id", metadata_id_col=["cat"])
    for n, meta, fused in ((122, True, True), (123, True, False), (124, False, True), (125, False, False)):
        schema = store.schema if meta else DataSchema(store.schema.num_users, store.schema.num_items)
        model = build_model(schema, ModelConfig(net_type="fm", n_factors=n))
        assert tfp.pairwise_kernel_applicable(model, TrainConfig()) == fused, (n, meta)
    rs = RecSys(_data(True), net_type="fm", n_factors=123, metadata_id_col=["cat"], device="cpu")
    losses = rs.fit(epochs=1, batch_size=128, verbose=False)
    assert not rs.trainer._fused and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_recsys_fm_fits_evaluates_and_predicts_like_jax(meta):
    """RecSys(net_type="fm", device="cpu") runs fit -> evaluate ->
    predict; served from the JAX facade's fitted tables it gives JAX's raw
    ids and, through catalog_topk, its values (sigmoid scores)."""
    data = _data(meta, n=2000, n_users=80, n_items=120)
    kw = dict(net_type="fm", n_factors=D, **(dict(metadata_id_col=["cat"]) if meta else {}))
    rs = RecSys(data, device="cpu", **kw)
    losses = rs.fit(epochs=2, batch_size=128, verbose=False)
    assert len(losses) == 2 and np.isfinite(losses).all()
    ev = rs.evaluate(batch_size=64, eval_metrics=("loss", "auc", "recall@10"), verbose=False)
    assert list(ev) == ["loss", "auc", "recall@10"] and all(np.isfinite(list(ev.values())))
    users = rs.store.user_encoder.to_list()[:12]
    assert rs.predict(users, top_k=5, exclude_seen=True).shape == (12, 5)

    jrs = JRecSys(data, **kw)
    jrs.fit(epochs=1, batch_size=128, verbose=False)
    rs.load_jax_tables({k: np.asarray(v) for k, v in jrs.state["tables"].items()})
    for top_k, excl in ((10, False), (10, True), (40, False)):
        np.testing.assert_array_equal(rs.predict(users, top_k=top_k, exclude_seen=excl),
                                      jrs.predict(users, top_k=top_k, exclude_seen=excl))
    rows = np.asarray([rs.store.user_encoder.encode_one(u) for u in users])
    jv, ji = jpred.catalog_topk(jrs.model, {"tables": jrs.state["tables"], "dense": {}}, {},
                                jnp.asarray(rows, jnp.int32), jrs.store.schema.num_items,
                                jrs.trainer.feature_tables(jrs.store), top_k=10)
    tv, ti = tpred.catalog_topk(rs.model, rs._params(), {}, torch.from_numpy(rows),
                                rs.store.schema.num_items, rs.feat, top_k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    assert bool(((tv > 0) & (tv < 1)).all())  # the sigmoid transform
    metrics = ("loss", "auc", "recall@5")
    want = jrs.evaluate(batch_size=64, eval_metrics=metrics, verbose=False)
    got = rs.evaluate(batch_size=64, eval_metrics=metrics, verbose=False)
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6, err_msg=m)
    vecs, bias = rs.item_vectors()
    assert vecs.shape == (rs.store.schema.num_items, D) and bias.shape == (rs.store.schema.num_items,)


def test_fm_sigmoid_refuses_sampled_softmax_and_carries_over():
    """fm_sigmoid=True (the default) with loss="sampled_softmax" raises
    ValueError; fm_sigmoid=False trains it. load_jax_tables takes FM's
    tables and refuses a missing linear table."""
    data = _data(True, n=1500, n_users=60, n_items=90)
    rs = RecSys(data, net_type="fm", n_factors=8, metadata_id_col=["cat"], device="cpu")
    assert rs.model.cfg.fm_sigmoid and rs.model.pairwise_sigmoid
    with pytest.raises(ValueError, match="sampled_softmax"):
        rs.fit(loss="sampled_softmax")
    assert rs.state is None
    raw = RecSys(data, net_type="fm", n_factors=8, metadata_id_col=["cat"], fm_sigmoid=False, device="cpu")
    assert not raw.model.pairwise_sigmoid
    losses = raw.fit(epochs=2, batch_size=128, loss="sampled_softmax", verbose=False)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    tables = {k: v.numpy() for k, v in raw.state["tables"].items()}
    assert tables["linear_meta_cat"].shape[1] == 1 and tables["linear_user"].shape[1] == 1
    out = tables_from_jax(tables, rs.model, "cpu")
    assert set(out) == set(tables)
    with pytest.raises(ValueError, match="names"):
        tables_from_jax({k: v for k, v in tables.items() if k != "linear_meta_cat"}, rs.model, "cpu")


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_fm_epochs_on_card_match_cpu(cuda_device, meta):
    """Same start, keys and static negatives: the card's FM epochs agree
    with the CPU's plain steps. Without metadata every step is one call of
    the step kernel (its sigmoid variant); with metadata one row-level
    launch (emit_g, item_upd=False) and no step-kernel call. index_add_
    and the kernel's atomics add duplicates in no fixed order, hence the
    tolerance."""
    data = _data(meta, n=4000, n_users=300, n_items=500)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    store = prepare_data(data, "user_id", "item_id", **kw)
    cfg = TrainConfig(batch_size=256, learning_rate=0.05)
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, ModelConfig(net_type="fm", n_factors=80)), cfg, dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: v.clone() for k, v in state["tables"].items()}
        else:
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
        data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
        before = (tfp.fused_pairwise_step.launches, tfp.fused_pairwise_step_meta.launches,
                  tfp.pairwise_updates_rows.launches)
        losses = []
        for e in range(2):
            state, loss = tr.train_epoch(state, data_d, feat, keys=torch.arange(6) + 7 * e)
            losses.append(float(loss))
        if dev != "cpu":
            steps = 2 * -(-store.num_train // 256)
            grew = (tfp.fused_pairwise_step.launches - before[0], tfp.fused_pairwise_step_meta.launches - before[1],
                    tfp.pairwise_updates_rows.launches - before[2])
            assert grew == ((0, 0, steps) if meta else (steps, 0, 0))
            if meta:  # hinge, sigmoid, weighted, emit_g, no item rows, f32
                assert tfp.pairwise_updates_rows.variant == tfp.row_variant("hinge", True, True, True, False, False)
            else:
                assert tfp.fused_pairwise_step.variant == tfp.step_variant("hinge", True, True, False, False)
        out[str(dev)] = (losses, {k: v.cpu() for k, v in state["tables"].items()})
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
    for k in tc:
        torch.testing.assert_close(tg[k], tc[k], rtol=1e-4, atol=1e-5)

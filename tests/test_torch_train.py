"""The port's training slice (torchrecsys_tpu_torch/train/, RecSys.fit)
against the JAX package's Trainer.

Epoch parity: both trainers start from the same state (the JAX trainer's
init, carried over with ``train_state_from_jax``), train on the same
static negatives (``dynamic_neg_sampling=False``; the store's split and
negatives are bit-identical), and each epoch's Feistel round keys are the
ones the JAX trainer derives from its ``state["rng"]``, handed to the port.
Linear with and without a multi-hot metadata column, hinge/bpr/logistic,
560 train rows in batches of 128 (a zero-weighted remainder batch), two
epochs, against the JAX kernel path (``pallas_step=True``, interpret mode)
and its XLA step (``pallas_step=False``). Epoch losses, every table and
every accumulator are held within rtol=1e-5, atol=1e-6, as the JAX package
holds its own two paths (tests/test_fused_pairwise.py:50-142).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train import losses as jlosses
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.data.sampling import sample_negatives
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train import losses as tlosses
from torchrecsys_tpu_torch.train.optim import augment_tables, init_embedding_opt, split_augmented
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

RTOL, ATOL = 1e-5, 1e-6


def _data(meta: bool, n=700, n_users=50, n_items=40, seed=0):
    r = np.random.default_rng(seed)
    items = r.integers(0, n_items, n)
    data = {"user_id": r.integers(0, n_users, n), "item_id": items}
    if meta:  # ragged lists: one or two ids per item
        data["cat"] = np.asarray(
            [[int(i % 5)] + ([int(i % 3) + 5] if i % 2 else []) for i in items], dtype=object
        )
    return data


def _state_np(state):
    return {
        "tables": {k: np.asarray(v) for k, v in state["tables"].items()},
        "emb_opt": {k: {"acc": np.asarray(v["acc"])} for k, v in state["emb_opt"].items()},
        "step": np.asarray(state["step"]),
    }


def _round_keys(rng):
    """The keys JAX's _epoch_fn feeds random_permutation (trainer.py:617,
    permute.py:57-59)."""
    _, k_shuffle = jax.random.split(rng)
    keys = jax.random.randint(k_shuffle, (6,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("pallas_step", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_two_epochs_match_jax_trainer(meta, loss, pallas_step):
    data = _data(meta)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    jmodel = jbuild(jstore.schema, JModelConfig(n_factors=16))
    tmodel = build_model(tstore.schema, ModelConfig(n_factors=16))
    jt = JTrainer(jmodel, JTrainConfig(
        batch_size=128, learning_rate=0.05, loss=loss, seed=3, pallas_step=pallas_step,
    ))
    tt = Trainer(tmodel, TrainConfig(batch_size=128, learning_rate=0.05, loss=loss, seed=3), "cpu")
    assert jt._pallas_pairwise() == pallas_step
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tmodel, "cpu")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    assert tstore.num_train % 128 != 0  # the remainder batch is exercised
    for _ in range(2):
        keys = _round_keys(jstate["rng"])
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    assert tstate["step"] == int(jstate["step"])
    for name in jstate["tables"]:
        np.testing.assert_allclose(
            tstate["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
            rtol=RTOL, atol=ATOL, err_msg=f"table {name}",
        )
        np.testing.assert_allclose(
            tstate["emb_opt"][name]["acc"].numpy(), np.asarray(jstate["emb_opt"][name]["acc"]),
            rtol=RTOL, atol=ATOL, err_msg=f"acc {name}",
        )


def test_epoch_builder_sorts_each_batch_by_user_and_weights_the_filler():
    store = prepare_data(_data(False), "user_id", "item_id")
    tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)), TrainConfig(batch_size=128), "cpu")
    data = tr._device_train_data(store)
    ep = tr.build_epoch(data, torch.arange(6), torch.Generator().manual_seed(0))
    n = store.num_train
    assert (ep.nb, ep.b) == (-(-n // 128), 128)
    assert ep.weight_sums == [128] * (ep.nb - 1) + [n - 128 * (ep.nb - 1)]
    assert ep.batches["_w"].sum(dim=1).tolist() == ep.weight_sums
    u = ep.batches["user_id"]
    assert bool((u[:, 1:] >= u[:, :-1]).all())
    # every train row appears once among the weighted rows
    pairs = sorted(zip(
        u[ep.batches["_w"] > 0].tolist(), ep.batches["pos_item_id"][ep.batches["_w"] > 0].tolist()
    ))
    assert pairs == sorted(zip(store.train_users.tolist(), store.train_items.tolist()))
    drop = Trainer(tr.model, TrainConfig(batch_size=128, drop_remainder=True), "cpu")
    ep2 = drop.build_epoch(data, torch.arange(6), torch.Generator().manual_seed(0))
    assert ep2.nb == n // 128 and "_w" not in ep2.batches


@pytest.mark.parametrize("name", ["hinge", "bpr", "logistic"])
def test_per_row_losses_match_jax(name):
    r = np.random.default_rng(0)
    pos = r.normal(size=64).astype(np.float32)
    neg = r.normal(size=(3, 64)).astype(np.float32)
    neg[0, :8] = pos[:8] - 1.0  # hinge kink rows
    want = np.asarray(jlosses.get_per_row_loss(name)(jnp.asarray(pos), jnp.asarray(neg), 1.0))
    got = tlosses.get_per_row_loss(name)(torch.from_numpy(pos), torch.from_numpy(neg), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    mean = tlosses.LOSS_REGISTRY[name](torch.from_numpy(pos), torch.from_numpy(neg[0]), 1.0)
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jlosses.LOSS_REGISTRY[name](jnp.asarray(pos), jnp.asarray(neg[0]), 1.0)),
        rtol=RTOL, atol=ATOL,
    )


def test_hinge_subgradient_splits_at_the_kink():
    pos = torch.tensor([1.0, 1.0, 1.0], requires_grad=True)
    neg = torch.tensor([0.0, 1.0, -1.0])  # diff = 0, 1, -1
    tlosses.hinge_loss(pos, neg, 1.0).backward()
    np.testing.assert_allclose(pos.grad.numpy(), [-0.5 / 3, -1 / 3, 0.0])


def test_augmented_layout_round_trip():
    g = torch.Generator().manual_seed(0)
    tables = {"a": torch.randn(6, 4, generator=g), "b": torch.randn(6, 1, generator=g)}
    opt = init_embedding_opt("rowwise_adagrad", tables)
    opt["a"]["acc"] += 2.0
    aug = augment_tables(tables, opt)
    assert aug["a"].shape == (6, 5) and bool((aug["a"][:, 4] == 2.0).all())
    back, opt2 = split_augmented(aug)
    for k in tables:
        assert torch.equal(back[k], tables[k]) and torch.equal(opt2[k]["acc"], opt[k]["acc"])


def test_sample_negatives_range_collisions_and_uniformity():
    g = torch.Generator().manual_seed(0)
    n_items = 10
    pos = torch.randint(0, n_items, (200_000,), generator=g)
    neg = sample_negatives(g, pos, n_items, avoid_collisions=True)
    assert neg.dtype == torch.int64 and neg.shape == pos.shape
    assert bool(((neg >= 0) & (neg < n_items)).all())
    assert not bool((neg == pos).any())
    # given the positive, the negative is uniform over the other 9 items
    for p in (0, 4, 9):
        counts = torch.bincount(neg[pos == p], minlength=n_items).double()
        assert counts[p] == 0
        share = counts[torch.arange(n_items) != p] / counts.sum()
        assert float((share - 1 / 9).abs().max()) < 0.01
    free = sample_negatives(g, pos, n_items, avoid_collisions=False)
    share = torch.bincount(free, minlength=n_items).double() / free.numel()
    assert float((share - 0.1).abs().max()) < 0.01
    assert bool((free == pos).any())


def _structured(n=6000, n_users=120, n_items=200, seed=0):
    """User block u % 4 prefers item block i % 4."""
    r = np.random.default_rng(seed)
    users = r.integers(0, n_users, n)
    items = (r.integers(0, n_items // 4, n) * 4 + users % 4) % n_items
    return {"user_id": users, "item_id": items, "cat": items % 7}


def test_fit_then_predict_serves_the_trained_tables():
    rs = RecSys(_structured(), metadata_id_col=["cat"], n_factors=16, device="cpu",
                dynamic_neg_sampling=True, seed=1)
    users = rs.store.user_encoder.to_list()[:20]
    losses = rs.fit(epochs=3, batch_size=256, learning_rate=0.05, verbose=False)
    assert len(losses) == 3 and losses[-1] < losses[0]
    steps = -(-rs.store.num_train // 256)
    assert rs.state["step"] == 3 * steps
    before = rs.predict(users, top_k=5)
    # predict serves the installed tables: the same top-k as scoring them
    q, ib, user_fn, _ = rs.model.linearized_catalog(rs._params(), rs.feat)
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users])
    uv, _ = user_fn(rs._params(), rows)
    scores = uv @ q.T + ib
    top = torch.argsort(-scores, dim=1, stable=True)[:, :5].numpy()
    np.testing.assert_array_equal(before, rs._decode_items(top, True, False))
    # a further fit moves the tables and predict follows (no stale catalog)
    item_before = rs.state["tables"]["item"].clone()
    rs.fit(epochs=1, batch_size=256, learning_rate=0.05, verbose=True)
    assert not torch.equal(rs.state["tables"]["item"], item_before)
    assert rs.model.tables["item"] is rs.state["tables"]["item"]
    q2, _, _, _ = rs._linearized()
    torch.testing.assert_close(q2, rs.model.linearized_catalog(rs._params(), rs.feat)[0])
    # the block structure was learnt: most recommendations are on-block
    rec = rs.predict(users, top_k=5)
    on_block = np.mean([(np.asarray(r) % 4 == u % 4).mean() for u, r in zip(users, rec)])
    assert on_block > 0.5


def test_fit_continues_from_carried_over_state():
    data = _data(True)
    rs = RecSys(data, metadata_id_col=["cat"], n_factors=16, device="cpu")
    jrs_model = jbuild(
        jprepare(data, "user_id", "item_id", metadata_id_col=["cat"]).schema,
        JModelConfig(n_factors=16),
    )
    jt = JTrainer(jrs_model, JTrainConfig(seed=0))
    st = _state_np(jt.init_state(jax.random.PRNGKey(0)))
    st["emb_opt"]["item"]["acc"] = st["emb_opt"]["item"]["acc"] + 1.0
    rs.load_jax_tables(st["tables"], st["emb_opt"])
    assert bool((rs.state["emb_opt"]["item"]["acc"] == 1.0).all())
    rs.fit(epochs=1, batch_size=64, verbose=False)
    assert bool((rs.state["emb_opt"]["item"]["acc"] >= 1.0).all())
    with pytest.raises(ValueError, match="emb_opt"):
        rs.load_jax_tables(st["tables"], {"item": {"acc": np.zeros(3, np.float32)}})


@pytest.mark.parametrize("kw", [dict(profile_epochs=1)])
def test_unported_fit_options_raise(kw, tmp_path, monkeypatch):
    """``profile_epochs``, once refused, now runs: the fit trains and its
    first epoch writes a torch.profiler trace into the default directory
    under the temp dir."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    losses = rs.fit(epochs=2, verbose=False, **kw)
    assert rs.state is not None and len(losses) == 2 and np.isfinite(losses).all()
    traces = list((tmp_path / "torchrecsys_tpu_torch_trace").glob("*.pt.trace.json"))
    assert len(traces) == 1


@pytest.mark.parametrize("kw", [dict(num_negatives=2), dict(neg_sampling="popularity")])
def test_sampled_softmax_refuses_explicit_negatives(kw):
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    with pytest.raises(ValueError, match="sampled_softmax"):
        rs.fit(loss="sampled_softmax", **kw)
    assert rs.state is None


def test_amp_training_and_unknown_options():
    rs = RecSys(_data(False), n_factors=8, device="cpu", use_amp=True)
    losses = rs.fit(verbose=False)  # the fused step's bf16 variant (plain on the CPU)
    assert rs.trainer._fused and np.isfinite(losses).all()
    losses = rs.fit(loss="sampled_softmax", verbose=False)  # bf16 h, v into the CE
    assert rs.trainer._softmax and np.isfinite(losses).all()
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    with pytest.raises(ValueError, match="unknown loss"):
        rs.fit(loss="nope")
    with pytest.raises(ValueError, match="dense optimizer"):
        rs.fit(optimizer="nope")
    for net in ("lstm", "sasrec"):
        assert build_model(rs.store.schema, ModelConfig(net_type=net, n_factors=8)).needs_history
    with pytest.raises(ValueError, match="divisible by sasrec_heads"):
        build_model(rs.store.schema, ModelConfig(net_type="sasrec", n_factors=9))
    with pytest.raises(ValueError, match="plus 'ease' via"):  # JAX's refusal: EASE builds directly
        build_model(rs.store.schema, ModelConfig(net_type="ease"))
    wide = build_model(rs.store.schema, ModelConfig(n_factors=125))
    assert not tfp.pairwise_kernel_applicable(wide, TrainConfig())
    # a model the fused kernel refuses trains through the autograd step
    assert not Trainer(wide, TrainConfig(), "cpu")._fused


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_run_steps_makes_one_step_call_per_batch_into_one_loss_tensor(meta, monkeypatch):
    """run_steps calls the step wrapper once per batch, each with the
    epoch's one (nb,) loss tensor and its own slot, and returns that
    tensor: the same losses and tables as the plain steps run one by one."""
    store = prepare_data(_data(meta), "user_id", "item_id",
                         **(dict(metadata_id_col=["cat"]) if meta else {}))
    tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)), TrainConfig(batch_size=128), "cpu")
    state = tr.init_state()
    data, feat = tr._device_train_data(store), tr.feature_tables(store)
    ep = tr.build_epoch(data, torch.arange(6), torch.Generator().manual_seed(0))
    name = "fused_pairwise_step_meta" if meta else "fused_pairwise_step"
    real, calls = getattr(tfp, name), []

    def spy(*a, **k):
        calls.append((k["loss_out"], k["loss_index"]))
        return real(*a, **k)

    monkeypatch.setattr(tfp, name, spy)
    packed = tr.pack_state(state)
    losses = tr.run_steps(packed, ep, feat)
    assert losses.shape == (ep.nb,) and len(calls) == ep.nb
    assert all(out is losses for out, _ in calls) and [i for _, i in calls] == list(range(ep.nb))
    # the same steps, one plain call at a time
    want = tr.pack_state(state)
    bt = ep.batches
    kw = dict(d=8, margin=1.0, loss_kind="hinge", sigmoid=False)
    for i in range(ep.nb):
        ids = (bt["user_id"][i], bt["pos_item_id"][i], bt["neg_item_id"][i])
        w, ws = bt["_w"][i], ep.weight_sums[i]
        if meta:
            names = tr.model.schema.metadata_names
            *_, loss = tfp.fused_pairwise_step_meta_plain(
                want["user"], want["item"], [want[f"meta_{n}"] for n in names], feat["meta_ids"],
                feat["meta_mask"], *ids, w, 0.01, weight_sum=ws, **kw)
        else:
            *_, loss = tfp.fused_pairwise_step_plain(want["user"], want["item"], *ids, w, 0.01,
                                                     weight_sum=ws, **kw)
        assert float(losses[i]) == float(loss)
    for k in want:
        assert torch.equal(packed[k], want[k]), k


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
def test_epochs_on_card_match_cpu(cuda_device, meta):
    """Same start, keys and static negatives: the card's epochs (every
    step one call of the step kernel, no row-level launch) agree with the
    CPU's plain steps. The kernel's atomics add duplicates in no fixed
    order, hence the tolerance."""
    data = _data(meta, n=4000, n_users=300, n_items=500)
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    store = prepare_data(data, "user_id", "item_id", **kw)
    cfg = TrainConfig(batch_size=256, learning_rate=0.05)
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, ModelConfig(n_factors=80)), cfg, dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: v.clone() for k, v in state["tables"].items()}
        else:
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
        data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
        step = tfp.fused_pairwise_step_meta if meta else tfp.fused_pairwise_step
        before = step.launches, tfp.pairwise_updates_rows.launches
        losses = []
        for e in range(2):
            state, loss = tr.train_epoch(state, data_d, feat, keys=torch.arange(6) + 7 * e)
            losses.append(float(loss))
        if dev != "cpu":
            assert step.launches - before[0] == 2 * -(-store.num_train // 256)
            assert tfp.pairwise_updates_rows.launches == before[1]
        out[str(dev)] = (losses, {k: v.cpu() for k, v in state["tables"].items()})
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
    for k in tc:
        torch.testing.assert_close(tg[k], tc[k], rtol=1e-4, atol=1e-5)

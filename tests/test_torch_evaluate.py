"""The port's sampled-softmax training and evaluation
(torchrecsys_tpu_torch/train/trainer.py, eval/metrics.py,
RecSys.evaluate) against the JAX package.

Training parity as in tests/test_torch_train.py: both trainers start from
the JAX trainer's init (carried over with ``train_state_from_jax``) and
each epoch uses the Feistel round keys the JAX trainer derives. Two epochs
of ``loss="sampled_softmax"`` against the JAX kernel route
(``pallas_softmax=True``, kernels #4 and #5 in interpret mode) and its XLA
formulation, with and without metadata: losses, tables and accumulators
within rtol=2e-4, atol=1e-6, the tolerance the JAX package holds its own
two routes to (tests/test_softmax.py:395-396).

Evaluation takes exact inputs: the store's static test negatives for a
pairwise loss, and for sampled softmax the JAX package's own threefry draws
handed to the port through ``Trainer.evaluate(negatives=...)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.eval import metrics as jmetrics
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.eval import metrics as tmetrics
from torchrecsys_tpu_torch.eval.predict import ranking_eval
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.models.linear import LinearModel
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests.test_torch_train import _data, _round_keys, _state_np, _structured

RTOL, ATOL = 2e-4, 1e-6
SOFTMAX = "sampled_softmax"


def _pair(data, meta, loss, n_factors=16, jcfg=None, tcfg=None, dynamic=False):
    """JAX and port stores, models and trainers on the same data."""
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=dynamic, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=dynamic, **kw)
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(n_factors=n_factors)), JTrainConfig(
        batch_size=128, learning_rate=0.05, loss=loss, seed=3, **(jcfg or {})))
    tt = Trainer(build_model(tstore.schema, ModelConfig(n_factors=n_factors)),
                 TrainConfig(batch_size=128, learning_rate=0.05, loss=loss, seed=3, **(tcfg or {})),
                 "cpu")
    return jstore, tstore, jt, tt


def _assert_states(tstate, jstate, rtol=RTOL, atol=ATOL):
    assert tstate["step"] == int(jstate["step"])
    for name in jstate["tables"]:
        np.testing.assert_allclose(tstate["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=rtol, atol=atol, err_msg=f"table {name}")
        np.testing.assert_allclose(tstate["emb_opt"][name]["acc"].numpy(),
                                   np.asarray(jstate["emb_opt"][name]["acc"]),
                                   rtol=rtol, atol=atol, err_msg=f"acc {name}")


def _train_both(jstore, tstore, jt, tt, epochs=2):
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    losses = []
    for _ in range(epochs):
        keys = _round_keys(jstate["rng"])
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys)
        losses.append((float(tloss), float(jloss)))
    return jstate, tstate, losses


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_softmax_epochs_match_jax_trainer(meta, pallas):
    jstore, tstore, jt, tt = _pair(_data(meta), meta, SOFTMAX, jcfg=dict(pallas_softmax=pallas))
    assert tstore.num_train % 128 != 0  # the weighted remainder batch is exercised
    jstate, tstate, losses = _train_both(jstore, tstore, jt, tt)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_states(tstate, jstate)
    # the user bias is row-constant under the softmax: untouched, as in JAX
    np.testing.assert_array_equal(tstate["emb_opt"]["user_bias"]["acc"].numpy(), 0.0)


def test_softmax_without_logq_matches_jax_trainer():
    jstore, tstore, jt, tt = _pair(_data(False), False, SOFTMAX,
                                   jcfg=dict(logq_correction=False), tcfg=dict(logq_correction=False))
    assert "logq" not in tt.feature_tables(tstore)
    jstate, tstate, losses = _train_both(jstore, tstore, jt, tt)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    _assert_states(tstate, jstate)


def test_softmax_epoch_draws_and_keeps_no_negatives():
    store = prepare_data(_data(False), "user_id", "item_id", dynamic_neg_sampling=False)
    assert store.train_neg_items is not None
    tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)),
                 TrainConfig(loss=SOFTMAX, batch_size=128), "cpu")
    data = tr._device_train_data(store)
    assert sorted(data) == ["pos_item_id", "user_id"]
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    ep = tr.build_epoch(data, torch.arange(6), gen)
    assert "neg_item_id" not in ep.batches
    assert torch.equal(gen.get_state(), before)  # nothing drawn


def test_logq_from_is_bit_exact():
    jstore, tstore, jt, tt = _pair(_data(False, n=3000, n_items=300), False, SOFTMAX)
    for items in (tstore.train_items, tstore.test_items, np.zeros(0, np.int32)):
        np.testing.assert_array_equal(tt._logq_from(items).numpy(), np.asarray(jt._logq_from(items)))
    np.testing.assert_array_equal(tt.feature_tables(tstore)["logq"].numpy(),
                                  np.asarray(jt.feature_tables(jstore)["logq"]))


def test_softmax_config_validation():
    with pytest.raises(ValueError, match="num_negatives"):
        TrainConfig(loss=SOFTMAX, num_negatives=2)
    with pytest.raises(ValueError, match="neg_sampling"):
        TrainConfig(loss=SOFTMAX, neg_sampling="popularity")
    store = prepare_data(_data(False), "user_id", "item_id")

    class Joint(LinearModel):  # a score that does not factorize
        supports_sampled_softmax = False

    with pytest.raises(ValueError, match="does not factorize"):
        Trainer(Joint(store.schema, ModelConfig(n_factors=8)), TrainConfig(loss=SOFTMAX), "cpu")
    # a wide model trains under softmax (no pairwise-kernel limit on d)
    Trainer(build_model(store.schema, ModelConfig(n_factors=200)), TrainConfig(loss=SOFTMAX), "cpu")


def test_declared_user_site_must_pass_user_ids_through():
    store = prepare_data(_data(False), "user_id", "item_id")

    class Derived(LinearModel):
        def gathers(self, batch):
            g = super().gathers(batch)
            g["user"] = ("user", batch["user_id"] + 0)
            return g

    tr = Trainer(Derived(store.schema, ModelConfig(n_factors=8)),
                 TrainConfig(loss=SOFTMAX, batch_size=128), "cpu")
    with pytest.raises(ValueError, match="user_gather_sites"):
        tr.train_epoch(tr.init_state(), tr._device_train_data(store), tr.feature_tables(store))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _jax_eval_negatives(jt, jstate, jstore, b):
    """The negatives JAX's _eval_fn draws for each padded test batch
    (trainer.py:981-983), cut to the test rows."""
    n = jstore.num_test
    nb = -(-n // b)
    items = np.concatenate([jstore.test_items, jstore.test_items[: nb * b - n]])
    negs = [
        np.asarray(jt._sample_negs(jstate["rng"], 0x5EED + i, jnp.asarray(items[i * b:(i + 1) * b]),
                                   None, num=1))
        for i in range(nb)
    ]
    return np.concatenate(negs)[:n]


@pytest.mark.parametrize("loss", ["hinge", "bpr"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_pairwise_evaluate_matches_jax(meta, loss):
    """Static test negatives: the same inputs in both packages."""
    jstore, tstore, jt, tt = _pair(_data(meta), meta, loss)
    jstate, tstate, _ = _train_both(jstore, tstore, jt, tt, epochs=1)
    assert tstore.num_test % 64 != 0  # a padded, masked last batch
    want = jt.evaluate(jstate, jstore, batch_size=64, verbose=False)
    got = tt.evaluate(tstate, tstore, batch_size=64, verbose=False)
    assert set(got) == {"loss", "auc"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-6)


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_softmax_evaluate_matches_jax(meta, pallas):
    """The JAX package's negatives injected; its CE route (kernel #4 in
    interpret mode, or XLA) and the test-split logQ on both sides."""
    jstore, tstore, jt, tt = _pair(_data(meta), meta, SOFTMAX, jcfg=dict(pallas_softmax=pallas))
    jstate, tstate, _ = _train_both(jstore, tstore, jt, tt, epochs=1)
    negs = _jax_eval_negatives(jt, jstate, jstore, 64)
    want = jt.evaluate(jstate, jstore, batch_size=64, verbose=False)
    got = tt.evaluate(tstate, tstore, batch_size=64, verbose=False, negatives=negs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-6)


def test_softmax_eval_takes_the_test_split_logq():
    """Half the test items made train-cold (tests/test_softmax.py:434-464):
    the eval loss matches JAX's, which takes logQ from the TEST split, and
    stays near log(batch), not ~27 (a train-split logq would add
    -log(1e-12) to those columns)."""
    jstore, tstore, jt, tt = _pair(_data(False, n=3000, n_items=40), False, SOFTMAX)
    stores = []
    for store in (jstore, tstore):
        n_old = store.schema.num_items
        cold = np.where(np.arange(store.num_test) % 2 == 0, store.test_items + n_old, store.test_items)
        schema = dataclasses.replace(store.schema, num_items=2 * n_old)
        stores.append(dataclasses.replace(store, schema=schema, test_items=cold.astype(store.test_items.dtype)))
    jstore, tstore = stores
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(n_factors=16)), jt.cfg)
    tt = Trainer(build_model(tstore.schema, ModelConfig(n_factors=16)), tt.cfg, "cpu")
    jstate = jt.init_state(jax.random.PRNGKey(1))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu")
    negs = _jax_eval_negatives(jt, jstate, jstore, 128)
    want = jt.evaluate(jstate, jstore, batch_size=128, verbose=False)
    got = tt.evaluate(tstate, tstore, batch_size=128, verbose=False, negatives=negs)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL, atol=ATOL)
    assert got["loss"] < 12.0
    train_logq = tt._logq_from(tstore.train_items)
    assert float(train_logq[tstore.test_items].min()) < -27.0  # what eval must not use


def test_evaluate_negatives_are_seeded_per_call():
    data = _data(False)
    store = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=True)
    tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)),
                 TrainConfig(loss=SOFTMAX, batch_size=128), "cpu")
    state = tr.init_state()
    a = tr.evaluate(state, store, batch_size=50, verbose=False)
    b = tr.evaluate(state, store, batch_size=50, verbose=True)
    assert a == b
    with pytest.raises(ValueError, match="one item row per test row"):
        tr.evaluate(state, store, negatives=np.zeros(3, np.int64))
    empty = dataclasses.replace(store, test_users=store.test_users[:0], test_items=store.test_items[:0])
    assert tr.evaluate(state, empty) == {}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    r = np.random.default_rng(0)
    pos, neg = r.integers(0, 4, 500).astype(np.float32), r.integers(0, 4, 500).astype(np.float32)
    np.testing.assert_allclose(
        float(tmetrics.pairwise_auc(torch.from_numpy(pos), torch.from_numpy(neg))),
        float(jmetrics.pairwise_auc(jnp.asarray(pos), jnp.asarray(neg))), rtol=1e-7,
    )
    y_true, y_pred = r.integers(0, 20, (64, 3)), r.integers(0, 20, (64, 5))
    np.testing.assert_allclose(
        float(tmetrics.hit_rate(torch.from_numpy(y_true), torch.from_numpy(y_pred))),
        float(jmetrics.hit_rate(jnp.asarray(y_true), jnp.asarray(y_pred))), rtol=1e-7,
    )
    scores = r.integers(0, 5, (32, 50)).astype(np.float32)  # many ties: index order decides
    true_items = r.integers(0, 50, (32, 4))
    mask = r.random((32, 4)) < 0.7
    for k in (1, 5, 20):
        for m in (None, mask):
            args_t = (torch.from_numpy(scores), torch.from_numpy(true_items), k,
                      None if m is None else torch.from_numpy(m))
            args_j = (jnp.asarray(scores), jnp.asarray(true_items), k, None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(float(tmetrics.recall_at_k(*args_t)),
                                       float(jmetrics.recall_at_k(*args_j)), rtol=1e-6)
            for got, want in zip(tmetrics.precision_recall_at_k(*args_t),
                                 jmetrics.precision_recall_at_k(*args_j)):
                np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


def test_recsys_softmax_fit_learns_and_evaluates():
    rs = RecSys(_structured(), n_factors=16, device="cpu", dynamic_neg_sampling=True, seed=1)
    rs.init_tables()
    before = rs.evaluate(batch_size=256, eval_metrics=("auc",), verbose=False)
    losses = rs.fit(epochs=4, batch_size=256, learning_rate=0.05, loss=SOFTMAX, verbose=False)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert rs.state["step"] == 4 * -(-rs.store.num_train // 256)
    out = rs.evaluate(batch_size=256, eval_metrics=("auc", "loss", "recall@10"), verbose=False)
    assert list(out) == ["auc", "loss", "recall@10"]
    assert np.isfinite(out["loss"]) and out["auc"] > max(before["auc"], 0.6)
    # routing: loss/auc from the trainer, ranking metrics from ranking_eval
    assert rs.evaluate(batch_size=256, eval_metrics=("loss", "auc"), verbose=False) == \
        rs.trainer.evaluate(rs.state, rs.store, batch_size=256, verbose=False)
    want = ranking_eval(rs.model, rs._params(), {}, rs.store.test_users, rs.store.test_items,
                        rs.store.schema.num_items, rs.feat, ks=(5, 10))
    got = rs.evaluate(eval_metrics=("ndcg@5", "recall@10", "precision@5", "hit_rate@10"))
    assert got == {k: want[k] for k in ("ndcg@5", "recall@10", "precision@5", "hit_rate@10")}


def test_recsys_evaluate_errors_and_empty_split():
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    with pytest.raises(RuntimeError, match="evaluate"):
        rs.evaluate()
    rs.init_tables()
    for bad in ("nope", "recall@x", "foo@10", "recall@"):
        with pytest.raises(ValueError, match="unknown eval metric"):
            rs.evaluate(eval_metrics=("loss", bad))
    out = rs.evaluate(eval_metrics=("loss", "auc"), verbose=False)  # default hinge trainer
    assert set(out) == {"loss", "auc"} and rs.trainer.cfg.loss == "hinge"
    empty = RecSys(_data(False), n_factors=8, device="cpu", split_ratio=1.0)
    empty.init_tables()
    assert empty.store.num_test == 0 and empty.evaluate(eval_metrics=("loss", "recall@5")) == {}


def test_recsys_evaluate_matches_jax_recsys_on_carried_tables():
    """Hinge with static negatives through both facades, same tables."""
    from torchrecsys_tpu import RecSys as JRecSys

    data = _data(True)
    jrs = JRecSys(data, metadata_id_col=["cat"], n_factors=16)
    jrs.fit(epochs=1, batch_size=128, verbose=False)
    rs = RecSys(data, metadata_id_col=["cat"], n_factors=16, device="cpu")
    rs.load_jax_tables({k: np.asarray(v) for k, v in jrs.state["tables"].items()})
    metrics = ("loss", "auc", "recall@5", "ndcg@10")
    want = jrs.evaluate(batch_size=64, eval_metrics=metrics, verbose=False)
    got = rs.evaluate(batch_size=64, eval_metrics=metrics, verbose=False)
    assert list(got) == list(metrics)
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6, err_msg=m)


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
def test_softmax_epochs_on_card_match_cpu(cuda_device, meta):
    """Same start and keys: the card's epochs (both CE kernels every step)
    against the CPU's; index_add_ on the card adds duplicates in no fixed
    order, hence rtol=1e-4, atol=1e-5. Then evaluate with the same
    negatives."""
    from torchrecsys_tpu_torch.ops import softmax_ce as sce

    data = _data(meta, n=4000, n_users=300, n_items=500)
    store = prepare_data(data, "user_id", "item_id", **(dict(metadata_id_col=["cat"]) if meta else {}))
    cfg = TrainConfig(loss=SOFTMAX, batch_size=256, learning_rate=0.05)
    negs = np.random.default_rng(0).integers(0, store.schema.num_items, store.num_test)
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, ModelConfig(n_factors=80)), cfg, dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: v.clone() for k, v in state["tables"].items()}
        else:
            state["tables"] = {k: v.to(dev) for k, v in start.items()}
        data_d, feat = tr._device_train_data(store), tr.feature_tables(store)
        f0, b0 = sce.softmax_ce_fwd.launches, sce.softmax_ce_bwd.launches
        losses = []
        for e in range(2):
            state, loss = tr.train_epoch(state, data_d, feat, keys=torch.arange(6) + 7 * e)
            losses.append(float(loss))
        if dev != "cpu":
            steps = 2 * -(-store.num_train // 256)
            assert (sce.softmax_ce_fwd.launches - f0, sce.softmax_ce_bwd.launches - b0) == (steps, steps)
        ev = tr.evaluate(state, store, batch_size=512, verbose=False, negatives=negs)
        out[str(dev)] = (losses, {k: v.cpu() for k, v in state["tables"].items()}, ev)
    (lc, tc, ec), (lg, tg, eg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
    for k in tc:
        torch.testing.assert_close(tg[k], tc[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eg["loss"], ec["loss"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eg["auc"], ec["auc"], atol=2.0 / store.num_test)

"""The port's streaming fit (torchrecsys_tpu_torch/train/streaming.py,
Trainer.fit_streaming) against the JAX package's.

The stream's chunks and their order are the JAX stream's (fixed bounds,
the tail chunk kept, ``np.random.default_rng(seed)`` order). Two-epoch
fits go through both packages from the JAX trainer's init, carried over
with ``train_state_from_jax``, on the store's static negatives; JAX splits
``state["rng"]`` once per chunk visit (train/trainer.py:617), and the
port takes the round keys of that chain in visit order through
``fit_streaming(keys=...)``. Tolerances are those of the resident
epoch-parity tests: Linear with metadata (kernel #3's plain version
against JAX's kernel in interpret mode) rtol=1e-5, atol=1e-6
(tests/test_torch_train.py); the f32 MLP rtol=2e-4, atol=1e-6 and the AMP
MLP (kernels #6/#7's plain versions) its losses within rtol=0.08
(tests/test_torch_mlp.py); sampled softmax (kernels #4/#5's plain
versions) rtol=2e-4, atol=1e-6 (tests/test_torch_evaluate.py).
"""

import jax
import numpy as np
import pytest
import torch

from torchrecsys_tpu.train import SuperBatchStream as JSuperBatchStream
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp
from torchrecsys_tpu_torch.parallel import make_mesh
from torchrecsys_tpu_torch.train import SuperBatchStream, Trainer, fit_streaming
from torchrecsys_tpu_torch.utils.convert import train_state_from_jax

from tests import test_torch_evaluate as tev
from tests import test_torch_mlp as tmlp
from tests.test_torch_train import _data, _round_keys

SB = 200  # 560 train rows: chunks of 200, 200 and 160, each with a weighted remainder batch of 128


def _chunks(stream):
    return [c["x"] for c in stream.epoch()]


def test_stream_covers_every_row_once_and_keeps_the_tail():
    stream = SuperBatchStream({"x": np.arange(1003, dtype=np.int32)}, 250, seed=0, device="cpu")
    assert (stream.num_super, stream.sb) == (5, 250)
    chunks = _chunks(stream)
    assert all(c.dtype == torch.int64 for c in chunks)  # the resident split's dtype
    assert sorted(torch.cat(chunks).tolist()) == list(range(1003))
    assert sorted(c.shape[0] for c in chunks) == [3, 250, 250, 250, 250]
    tail = next(c for c in chunks if c.shape[0] == 3)
    assert tail.tolist() == [1000, 1001, 1002]  # fixed bounds: the tail rows travel together
    orders = [[int(c[0]) for c in _chunks(stream)] for _ in range(2)]
    assert orders[0] != orders[1]  # a fresh order each epoch
    one = SuperBatchStream({"x": np.arange(10)}, 1 << 21, device="cpu")
    assert (one.num_super, one.sb) == (1, 10)


@pytest.mark.parametrize("seed", [0, 7])
def test_chunk_order_equals_jax_stream(seed):
    arrays = {"x": np.arange(1003, dtype=np.int32), "y": np.arange(1003, dtype=np.int32) * 3}
    jstream = JSuperBatchStream(arrays, 100, seed=seed)
    tstream = SuperBatchStream(arrays, 100, seed=seed, device="cpu")
    for _ in range(3):
        want = [{k: np.asarray(v) for k, v in c.items()} for c in jstream.epoch()]
        got = list(tstream.epoch())
        assert len(got) == len(want) == 11
        for g, w in zip(got, want):
            for k in arrays:
                np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_a_sharding_raises_naming_item_14():
    """A sharding that is not parallel.sharding.batch_sharding(mesh) is
    refused; an MLP on a mesh (item 14b, now ported) streams: on a
    one-rank CPU mesh as it does without one."""
    with pytest.raises(TypeError, match="batch_sharding"):
        SuperBatchStream({"x": np.arange(10)}, 4, sharding=object(), device="cpu")
    runs = []
    for mesh in (None, make_mesh(device="cpu")):
        rs = RecSys(_data(False), n_factors=4, net_type="mlp", hidden_layers=(8, 4), device="cpu", mesh=mesh)
        fit = rs.fit(epochs=1, batch_size=32, verbose=False)
        state, losses = rs.trainer.fit_streaming(rs.state, rs.store, superbatch_size=128, epochs=1,
                                                 verbose=False)
        runs.append((fit + losses, state))
    assert runs[0][0] == runs[1][0]
    for name, t in runs[0][1]["tables"].items():
        assert torch.equal(t, runs[1][1]["tables"][name])
    with pytest.raises(ValueError, match="lengths differ"):
        SuperBatchStream({"x": np.arange(10), "y": np.arange(9)}, 4, device="cpu")


def test_the_stream_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        SuperBatchStream({"x": np.arange(10)}, 4)


@pytest.mark.parametrize("cfg", [
    dict(meta=True, loss="hinge", dynamic=True),
    dict(meta=False, loss="sampled_softmax", dynamic=False),
], ids=["linear-meta-dynamic", "softmax"])
def test_one_chunk_equals_the_resident_fit(cfg):
    """``superbatch_size >= num_train``: one chunk, the split in its own
    order, and the same generator draws as ``Trainer.fit``: the same
    losses and state, bit for bit."""
    kw = dict(metadata_id_col=["cat"]) if cfg["meta"] else {}
    store = prepare_data(_data(cfg["meta"]), "user_id", "item_id", dynamic_neg_sampling=cfg["dynamic"], **kw)
    runs = []
    for streamed in (False, True):
        tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)),
                     TrainConfig(batch_size=128, learning_rate=0.05, loss=cfg["loss"], seed=4), "cpu")
        state = tr.init_state()
        if streamed:
            runs.append(tr.fit_streaming(state, store, superbatch_size=store.num_train, epochs=2, verbose=False))
        else:
            runs.append(tr.fit(state, store, epochs=2, verbose=False))
    (rs, rl), (ss, sl) = runs
    assert sl == rl and ss["step"] == rs["step"]
    for name in rs["tables"]:
        assert torch.equal(ss["tables"][name], rs["tables"][name]), name
        assert torch.equal(ss["emb_opt"][name]["acc"], rs["emb_opt"][name]["acc"]), name


def test_in_step_negatives_drop_the_stored_column(monkeypatch):
    store = prepare_data(_data(False), "user_id", "item_id", dynamic_neg_sampling=False)
    assert store.train_neg_items is not None
    for k, want in ((1, ["neg_item_id", "pos_item_id", "user_id"]), (2, ["pos_item_id", "user_id"])):
        tr = Trainer(build_model(store.schema, ModelConfig(n_factors=8)),
                     TrainConfig(batch_size=128, num_negatives=k), "cpu")
        seen, real = [], tr.train_epoch

        def record(state, data, feat, keys=None, negatives=None):
            seen.append((sorted(data), data["user_id"].dtype, data["user_id"].shape[0]))
            return real(state, data, feat, keys=keys, negatives=negatives)

        monkeypatch.setattr(tr, "train_epoch", record)
        _, losses = fit_streaming(tr, tr.init_state(), store, superbatch_size=SB, epochs=1, verbose=False)
        assert np.isfinite(losses).all()
        assert [s[0] for s in seen] == [want] * 3
        assert all(s[1] == torch.int64 for s in seen)
        assert sorted(s[2] for s in seen) == [store.num_train - 2 * SB, SB, SB]


def _jax_chunk_keys(rng, visits):
    """The round keys JAX's fit_streaming feeds each chunk: one split of
    ``state["rng"]`` per chunk visit (train/trainer.py:617)."""
    keys = []
    for _ in range(visits):
        keys.append(_round_keys(rng))
        rng = jax.random.split(rng)[0]
    return keys


def _stream_both(jstore, tstore, jt, tt, to_port, epochs=2):
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = to_port(js)
    visits = epochs * -(-tstore.num_train // SB)
    keys = _jax_chunk_keys(js["rng"], visits)
    js, jl = jt.fit_streaming(js, jstore, superbatch_size=SB, epochs=epochs, seed=5, verbose=False)
    ts, tl = tt.fit_streaming(ts, tstore, superbatch_size=SB, epochs=epochs, seed=5, verbose=False, keys=keys)
    assert tstore.num_train % SB and ts["step"] == int(js["step"])
    return js, ts, np.asarray(tl), np.asarray(jl)


def test_linear_metadata_streams_like_jax():
    jstore, tstore, jt, tt = tev._pair(_data(True), True, "hinge", jcfg=dict(pallas_step=True))
    assert jt._pallas_pairwise() and tt._fused
    js, ts, tl, jl = _stream_both(jstore, tstore, jt, tt, lambda j: train_state_from_jax(tev._state_np(j), tt.model,
                                                                                            "cpu"))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    tev._assert_states(ts, js, rtol=1e-5, atol=1e-6)


def test_sampled_softmax_streams_like_jax():
    jstore, tstore, jt, tt = tev._pair(_data(False), False, "sampled_softmax", jcfg=dict(pallas_softmax=True))
    js, ts, tl, jl = _stream_both(jstore, tstore, jt, tt, lambda j: train_state_from_jax(tev._state_np(j), tt.model,
                                                                                            "cpu"))
    np.testing.assert_allclose(tl, jl, rtol=tev.RTOL, atol=tev.ATOL)
    tev._assert_states(ts, js)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"], ids=["f32", "amp"])
def test_mlp_streams_like_jax(compute):
    # dense adagrad: adam turns the rounding of a bias gradient that batch
    # norm cancels into lr-sized steps (tests/test_torch_mlp.py)
    opt = dict(dense_optimizer="adagrad")
    jstore, tstore, jt, tt = tmlp._pair(_data(True), True, compute, jcfg=opt, tcfg=opt)

    def to_port(js):
        return train_state_from_jax(tmlp._state_np(js), tt.model, "cpu", dense_optimizer=tt.cfg.dense_optimizer)

    js, ts, tl, jl = _stream_both(jstore, tstore, jt, tt, to_port)
    if compute == "float32":
        np.testing.assert_allclose(tl, jl, rtol=2e-4, atol=1e-6)
        for key in ("tables", "dense", "model_state"):
            tmlp._assert_trees(ts[key], js[key], 2e-4, 1e-6, key)
    else:
        # the resident AMP fit's rule (test_amp_recsys_fit_evaluate_predict_track_jax)
        np.testing.assert_allclose(tl, jl, rtol=0.08)
        assert tl[-1] < tl[0]


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream's pinned buffers and copy stream exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_stream_stages_pinned_chunks(cuda_device):
    arrays = {"x": np.arange(100_003, dtype=np.int32), "y": np.arange(100_003, dtype=np.int64)}
    stream = SuperBatchStream(arrays, 10_000, seed=3, device=cuda_device)
    assert all(b.is_pinned() for slot in stream._pinned for b in slot.values())
    cpu = SuperBatchStream(arrays, 10_000, seed=3, device="cpu")
    for _ in range(2):
        for got, want in zip(stream.epoch(), cpu.epoch()):
            for k in arrays:
                assert got[k].is_cuda and got[k].dtype == torch.int64
                assert torch.equal(got[k].cpu(), want[k])


@pytest.mark.gpu
def test_card_streamed_fit_calls_the_step_kernel_per_batch(cuda_device):
    store = prepare_data(_data(True, n=4000, n_users=300, n_items=500), "user_id", "item_id",
                         metadata_id_col=["cat"])
    out = {}
    for dev in ("cpu", cuda_device):
        tr = Trainer(build_model(store.schema, ModelConfig(n_factors=80)),
                     TrainConfig(batch_size=256, learning_rate=0.05), dev)
        state = tr.init_state()
        if dev == "cpu":
            start = {k: v.clone() for k, v in state["tables"].items()}
        state["tables"] = {k: v.to(dev) for k, v in start.items()}
        before = tfp.fused_pairwise_step_meta.launches
        keys = [torch.arange(6) + 7 * i for i in range(4)]
        state, losses = tr.fit_streaming(state, store, superbatch_size=1000, epochs=1, verbose=False, keys=keys)
        if dev != "cpu":
            sizes = [1000] * (store.num_train // 1000) + [store.num_train % 1000]
            assert tfp.fused_pairwise_step_meta.launches - before == sum(-(-s // 256) for s in sizes)
        out[str(dev)] = (losses, {k: v.cpu() for k, v in state["tables"].items()})
    (lc, tc), (lg, tg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
    for k in tc:
        torch.testing.assert_close(tg[k], tc[k], rtol=1e-4, atol=1e-5)

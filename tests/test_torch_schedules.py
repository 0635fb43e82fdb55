"""lr schedules on the port (train/optim.py::make_lr_schedule, the dense
optimizers' schedule state, the per-step lr of the trainers) against the
JAX package.

``make_lr_schedule`` is held exactly, in f32, to optax's schedules
evaluated op by op (``jax.disable_jit``: each op rounded to f32 in optax's
order) at steps 0..3000, for all four dict kinds and a callable. Inside
``jit`` XLA folds constants (a divide by the step count becomes a multiply
by its f32 reciprocal) and contracts multiply-adds into FMAs, so the
traced JAX values differ from that by an ulp on some steps: the fits below
are held at the epoch parity tolerance (rtol=1e-5, atol=1e-6), which one
ulp of lr per step stays far inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrecsys_tpu.config import ModelConfig as JModelConfig
from torchrecsys_tpu.config import TrainConfig as JTrainConfig
from torchrecsys_tpu.data import prepare_data as jprepare
from torchrecsys_tpu.models import build_model as jbuild
from torchrecsys_tpu.train import Trainer as JTrainer
from torchrecsys_tpu.train.optim import make_dense_optimizer
from torchrecsys_tpu.train.optim import make_lr_schedule as jschedule
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.train.optim import apply_dense_update, init_dense_opt
from torchrecsys_tpu_torch.train.optim import make_lr_schedule as tschedule
from torchrecsys_tpu_torch.utils.convert import dense_opt_from_jax, train_state_from_jax

from tests.test_torch_mlp import _assert_trees, _np
from tests.test_torch_train import _data, _round_keys, _state_np

RTOL, ATOL = 1e-5, 1e-6

SPECS = {
    "cosine": {"kind": "cosine", "decay_steps": 2344},
    "cosine_alpha": {"kind": "cosine", "decay_steps": 1000, "alpha": 0.1},
    "step": {"kind": "step", "boundaries_and_scales": {100: 0.5, 1500: 0.1, 2900: 0.3}},
    "exponential": {"kind": "exponential", "transition_steps": 100, "decay_rate": 0.9},
    "exponential_stair": {"kind": "exponential", "transition_steps": 300, "decay_rate": 0.5,
                          "staircase": True},
    "linear": {"kind": "linear", "transition_steps": 2500},
    "linear_end": {"kind": "linear", "transition_steps": 1000, "end_value": 0.001},
}


@pytest.mark.parametrize("name", list(SPECS))
def test_schedule_equals_optax_in_f32(name):
    steps = np.arange(3001)
    with jax.disable_jit():
        want = np.asarray(jschedule(0.05, SPECS[name])(jnp.asarray(steps, jnp.int32)), np.float32)
    fn = tschedule(0.05, SPECS[name])
    got = np.asarray([fn(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert all(type(fn(s)) is float for s in (0, 7))


def test_callable_schedule_and_bad_specs():
    fn = tschedule(0.1, lambda step: 0.1 / (1 + step))
    assert fn(3) == float(np.float32(0.025))
    assert tschedule(0.1, None) is None and jschedule(0.1, None) is None
    for make in (tschedule, jschedule):
        with pytest.raises(KeyError, match="decay_steps"):
            make(0.1, {"kind": "cosine"})
        with pytest.raises(ValueError, match="unknown lr_schedule"):
            make(0.1, {"kind": "nope"})


def test_cosine_without_decay_steps_raises_jax_error_at_fit():
    """The facade refused every ``lr_schedule`` before the port had them;
    the spec without ``decay_steps`` now raises what the JAX package
    raises for it, when fit builds its trainer."""
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    with pytest.raises(KeyError, match="decay_steps"):
        rs.fit(lr_schedule={"kind": "cosine"})
    assert rs.state is None


@pytest.mark.parametrize("kind", ["adam", "adagrad", "sgd"])
def test_dense_optimizer_reads_the_schedule_at_its_count(kind):
    """Four steps under a step schedule from a carried-over optax state
    whose schedule count is 2: the port's dense update against optax's, the
    carried count included (``ScaleByScheduleState``)."""
    g = np.random.default_rng(2)
    dense = {"w": g.normal(size=(5, 3)).astype(np.float32), "b": g.normal(size=3).astype(np.float32)}
    spec = {"kind": "step", "boundaries_and_scales": {3: 0.5, 5: 0.1}}
    tx = make_dense_optimizer(kind, 0.05, schedule=jschedule(0.05, spec))
    jp = jax.tree.map(jnp.asarray, dense)
    jo = tx.init(jp)
    tp = jax.tree.map(torch.from_numpy, dense)
    to = init_dense_opt(kind, tp, schedule=True)
    assert to["schedule_count"] == 0
    for i in range(6):
        grads = jax.tree.map(lambda a: g.normal(size=a.shape).astype(np.float32), dense)
        upd, jo = tx.update(jax.tree.map(jnp.asarray, grads), jo, jp)
        jp = optax.apply_updates(jp, upd)
        if i == 1:  # carry the optax state over mid-way
            to = dense_opt_from_jax(_np(jo), kind, tp, "cpu")
            tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
            assert to["schedule_count"] == 2
            continue
        if i > 1:
            tp, to = apply_dense_update(kind, 0.05, tp, jax.tree.map(torch.from_numpy, grads), to,
                                        schedule=tschedule(0.05, spec))
    assert to["schedule_count"] == 6
    _assert_trees(tp, jp, 1e-6, 1e-7, f"{kind} params")
    back = dense_opt_from_jax(_np(jo), kind, tp, "cpu")
    assert back["schedule_count"] == to["schedule_count"]
    for key in (k for k in to if k not in ("count", "schedule_count")):
        _assert_trees(to[key], back[key], 1e-6, 1e-7, f"{kind} {key}")


def _fit_pair(meta, tcfg, jcfg, data=None, n_factors=16):
    data = _data(meta) if data is None else data
    kw = dict(metadata_id_col=["cat"]) if meta else {}
    jstore = jprepare(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    tstore = prepare_data(data, "user_id", "item_id", dynamic_neg_sampling=False, **kw)
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(n_factors=n_factors)),
                  JTrainConfig(batch_size=128, learning_rate=0.05, seed=3, **tcfg, **jcfg))
    tt = Trainer(build_model(tstore.schema, ModelConfig(n_factors=n_factors)),
                 TrainConfig(batch_size=128, learning_rate=0.05, seed=3, **tcfg), "cpu")
    return jstore, tstore, jt, tt


def _two_epochs(jstore, tstore, jt, tt, epochs=2):
    jstate = jt.init_state(jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_state_np(jstate), tt.model, "cpu")
    jdata, jfeat = jt._device_train_data(jstore), jt.feature_tables(jstore)
    tdata, tfeat = tt._device_train_data(tstore), tt.feature_tables(tstore)
    for _ in range(epochs):
        keys = _round_keys(jstate["rng"])
        jstate, jloss = jt._epoch_jit(jstate, jdata, jfeat)
        tstate, tloss = tt.train_epoch(tstate, tdata, tfeat, keys=keys)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    assert tstate["step"] == int(jstate["step"])
    for name in jstate["tables"]:
        np.testing.assert_allclose(tstate["tables"][name].numpy(), np.asarray(jstate["tables"][name]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"table {name}")
    return jstate, tstate


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_cosine_fit_through_the_step_matches_jax_kernel_path(meta):
    """Two epochs of 5 steps under a cosine schedule that decays to 0 at
    step 8: the port's fused step (plain on the CPU, every step at its own
    lr) against JAX's kernel path (``pallas_step=True``, interpret mode)."""
    sched = {"kind": "cosine", "decay_steps": 8}
    jstore, tstore, jt, tt = _fit_pair(meta, dict(lr_schedule=sched), dict(pallas_step=True))
    assert jt._pallas_pairwise() and tt._fused
    _, tstate = _two_epochs(jstore, tstore, jt, tt)
    assert [tt._lr_at(s) for s in (0, 8, 9)] == [float(np.float32(0.05)), 0.0, 0.0]


def test_step_schedule_softmax_fit_matches_jax():
    sched = {"kind": "step", "boundaries_and_scales": {3: 0.5, 6: 0.2}}
    jstore, tstore, jt, tt = _fit_pair(
        True, dict(lr_schedule=sched, loss="sampled_softmax"), dict(pallas_softmax=False)
    )
    _two_epochs(jstore, tstore, jt, tt)


def test_scheduled_lr_runs_on_across_fit_calls():
    """The schedule reads the global step: a second fit starts where the
    first stopped (on the CPU the step wrapper's plain version runs)."""
    rs = RecSys(_data(False), n_factors=8, device="cpu")
    sched = {"kind": "linear", "transition_steps": 10}
    seen = []
    real = Trainer._lr_at

    def spy(self, step):
        seen.append(step)
        return real(self, step)

    Trainer._lr_at = spy
    try:
        rs.fit(batch_size=128, lr_schedule=sched, verbose=False)
        rs.fit(batch_size=128, lr_schedule=sched, verbose=False)
    finally:
        Trainer._lr_at = real
    nb = -(-rs.store.num_train // 128)
    assert seen == list(range(2 * nb)) and rs.state["step"] == 2 * nb


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_train_state_with_a_schedule_carries_over_from_jax_init_state(kind):
    """A JAX trainer under an lr schedule adds ``ScaleByScheduleState`` to
    its dense optimizer's state; ``train_state_from_jax`` carries it as
    ``schedule_count`` beside the optimizer's own state."""
    data = _data(False)
    jstore = jprepare(data, "user_id", "item_id")
    tstore = prepare_data(data, "user_id", "item_id")
    mcfg = dict(net_type="mlp", n_factors=8, hidden_layers=(16,))
    sched = {"kind": "cosine", "decay_steps": 10}
    jt = JTrainer(jbuild(jstore.schema, JModelConfig(**mcfg)),
                  JTrainConfig(lr_schedule=sched, dense_optimizer=kind))
    tt = Trainer(build_model(tstore.schema, ModelConfig(**mcfg)),
                 TrainConfig(lr_schedule=sched, dense_optimizer=kind), "cpu")
    js = jt.init_state(jax.random.PRNGKey(0))
    assert type(js["dense_opt"][-1]).__name__ == "ScaleByScheduleState"
    st = {k: jax.tree.map(np.asarray, js[k]) for k in ("tables", "emb_opt", "dense", "model_state", "dense_opt")}
    ts = train_state_from_jax(st, tt.model, "cpu", dense_optimizer=kind)
    assert set(ts["dense_opt"]) == set(tt.init_state()["dense_opt"])
    assert ts["dense_opt"]["schedule_count"] == 0
    _assert_trees(ts["dense"], st["dense"], 0, 0, "dense")

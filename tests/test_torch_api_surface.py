"""The port's ``RecSys`` surface against the JAX facade's: every JAX
constructor keyword is accepted with the JAX default, the checkpoint and
incremental methods take the JAX parameters (``load`` then ``device``),
and what the port cannot run yet raises ``NotImplementedError`` naming
its ROADMAP.md item (the rule of ``torchrecsys_tpu_torch/config.py``)."""

import inspect

import numpy as np
import pytest

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.parallel import make_mesh

NEW_KEYWORDS = ("debug", "path", "mesh", "history_len", "ease_lam", "fm_sigmoid")


def _data(n=600, n_users=40, n_items=90, seed=0):
    r = np.random.default_rng(seed)
    return {"user_id": r.integers(0, n_users, n), "item_id": r.integers(0, n_items, n)}


def test_constructor_keywords_follow_jax_order():
    jax_names = list(inspect.signature(JRecSys.__init__).parameters)
    port_names = list(inspect.signature(RecSys.__init__).parameters)
    assert port_names[: len(jax_names)] == jax_names
    assert port_names[len(jax_names):] == ["device"]


@pytest.mark.parametrize("name", NEW_KEYWORDS)
def test_keyword_accepted_at_jax_default(name):
    default = inspect.signature(JRecSys.__init__).parameters[name].default
    assert inspect.signature(RecSys.__init__).parameters[name].default == default
    trs = RecSys(_data(), n_factors=4, device="cpu", **{name: default})
    assert getattr(trs, name) == default
    assert trs.config["num_users"] == 40


def test_stored_keywords_change_nothing_for_ported_nets():
    a = RecSys(_data(), n_factors=4, device="cpu", seed=3)
    b = RecSys(_data(), n_factors=4, device="cpu", seed=3, fm_sigmoid=False, history_len=5,
               ease_lam=1.0, path="elsewhere/")
    a.init_tables()
    b.init_tables()
    assert (b.fm_sigmoid, b.history_len, b.ease_lam, b.path) == (False, 5, 1.0, "elsewhere/")
    for name, t in a.model.tables.items():
        assert np.array_equal(t.numpy(), b.model.tables[name].numpy())


@pytest.mark.parametrize("kw, item", [({"mesh": object()}, "item 14")])
def test_unported_constructor_values_name_their_item(kw, item):
    """A mesh that is not a parallel.Mesh is refused; on a Mesh the nets
    of the generic mesh step (item 14b, now ported) run: an MLP on a
    one-rank CPU mesh fits and serves as it does without one."""
    with pytest.raises(TypeError, match="Mesh"):
        RecSys(_data(), n_factors=4, device="cpu", **kw)
    runs = []
    for mesh in (None, make_mesh(device="cpu")):
        rs = RecSys(_data(), n_factors=4, device="cpu", net_type="mlp", hidden_layers=(8, 4), mesh=mesh)
        losses = rs.fit(epochs=1, batch_size=32, verbose=False)
        runs.append((losses, rs.predict(rs.store.user_encoder.to_list()[:3], top_k=4)))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_load_takes_jax_parameters_then_device():
    jax_names = list(inspect.signature(JRecSys.load).parameters)
    port = inspect.signature(RecSys.load).parameters
    assert list(port) == jax_names + ["device"]
    assert port["mesh"].default is None and port["device"].default == "cuda"
    with pytest.raises(TypeError, match="Mesh"):
        RecSys.load("ckpt/", mesh=object(), device="cpu")


@pytest.mark.parametrize("method", ["save", "restore", "update_data", "partial_fit"])
def test_checkpoint_and_incremental_methods_follow_jax(method):
    jax_params = inspect.signature(getattr(JRecSys, method)).parameters
    port_params = inspect.signature(getattr(RecSys, method)).parameters
    assert list(port_params) == list(jax_params)
    assert [p.default for p in port_params.values()] == [p.default for p in jax_params.values()]

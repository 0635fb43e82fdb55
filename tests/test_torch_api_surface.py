"""The port's ``RecSys`` surface against the JAX facade's: every JAX
constructor keyword is accepted with the JAX default, and what the port
cannot run yet raises ``NotImplementedError`` naming its ROADMAP.md item
(the rule of ``torchrecsys_tpu_torch/config.py``)."""

import inspect

import numpy as np
import pytest

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu_torch import RecSys

NEW_KEYWORDS = ("debug", "path", "mesh", "history_len", "ease_lam", "fm_sigmoid")


def _data(n=600, n_users=40, n_items=90, seed=0):
    r = np.random.default_rng(seed)
    return {"user_id": r.integers(0, n_users, n), "item_id": r.integers(0, n_items, n)}


@pytest.fixture(scope="module")
def rs():
    return RecSys(_data(), n_factors=4, device="cpu")


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


@pytest.mark.parametrize("kw, item", [({"debug": True}, "item 4"), ({"mesh": object()}, "item 14")])
def test_unported_constructor_values_name_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md §A {item} "):
        RecSys(_data(), n_factors=4, device="cpu", **kw)


@pytest.mark.parametrize("method, args, item", [
    ("save", ("ckpt/",), "item 4"),
    ("restore", ("ckpt/",), "item 4"),
    ("update_data", (_data(seed=1),), "item 12"),
    ("partial_fit", (_data(seed=1),), "item 12"),
])
def test_unported_methods_name_their_item(rs, method, args, item):
    assert hasattr(JRecSys, method)
    with pytest.raises(NotImplementedError, match=rf"RecSys\.{method} .*ROADMAP\.md §A {item} "):
        getattr(rs, method)(*args)


def test_cold_load_names_its_item():
    assert list(inspect.signature(RecSys.load).parameters) == list(inspect.signature(JRecSys.load).parameters)
    with pytest.raises(NotImplementedError, match=r"RecSys\.load .*ROADMAP\.md §A item 4 "):
        RecSys.load("ckpt/")

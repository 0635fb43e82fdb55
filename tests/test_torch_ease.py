"""The port's EASE (torchrecsys_tpu_torch/models/ease.py and the EASE
branches of RecSys) against the JAX package's.

On the CPU, at small sizes. The host CSR (build, merge, ``seed_csr``) and
the binary X rows equal JAX's bit for bit. G = X^T X holds integer counts
below 2^24, exact in f32 in any order, so the port's G equals JAX's bit
for bit at every user chunk. B from the exact solve (``torch.linalg.inv``
against ``jnp.linalg.inv``: two LU factorizations) within rtol=1e-5,
atol=1e-6, the JAX package's own chunked-vs-one-chunk tolerance
(tests/test_models.py:161-173); the Newton-Schulz solve against JAX's and
against the exact one within rtol=1e-3, atol=1e-4 (tests/test_models.py:
227-238). Scores within rtol=1e-5, atol=1e-5; ids, ranking metrics and
raw ids equal. Pinned differences (ROADMAP.md §C): ``solve="auto"`` is the
exact solve (the port is never on a TPU); a cold load comes back with
``lam=100`` whatever ``ease_lam`` was, as JAX's does; the top-k is a
stable descending sort (``lax.top_k``'s lowest-index-first ties).
"""

import json
import os

import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.models import ease as jease
from torchrecsys_tpu.utils.checkpoint import load_aux as jload_aux
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig
from torchrecsys_tpu_torch.models import EASE, build_model
from torchrecsys_tpu_torch.models import ease as tease
from torchrecsys_tpu_torch.utils.convert import checkpoint_from_jax

B_RTOL, B_ATOL = 1e-5, 1e-6
IT_RTOL, IT_ATOL = 1e-3, 1e-4
METRICS = ("recall@10", "precision@5", "hit_rate@10", "ndcg@10", "ndcg@3")


def _pairs(n=400, n_users=50, n_items=20, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, n_users, n).astype(np.int32), r.integers(0, n_items, n).astype(np.int32)


def _both(n_users=50, n_items=20, lam=2.0):
    return jease.EASE(n_users, n_items, lam=lam), EASE(n_users, n_items, lam=lam, device="cpu")


def _data(n=1500, n_users=60, n_items=40, seed=0):
    r = np.random.default_rng(seed)
    return {"user_id": r.integers(0, n_users, n) * 7 + 1, "item_id": r.integers(0, n_items, n) * 3 + 2}


def _assert_csr(t, j):
    assert t.user_ptr.dtype == np.int64 and t.item_idx.dtype == np.int32
    np.testing.assert_array_equal(t.user_ptr, j.user_ptr)
    np.testing.assert_array_equal(t.item_idx, j.item_idx)
    assert t.nnz == j.nnz


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_csr_build_merge_and_seed_bit_for_bit():
    j, t = _both()
    u, i = _pairs()
    for m in (j, t):  # duplicates dedupe
        m._set_pairs(np.concatenate([u, u[:50]]), np.concatenate([i, i[:50]]))
    _assert_csr(t, j)
    u2, i2 = _pairs(n=100, seed=1)
    for m in (j, t):  # a merge with the pairs already held
        m._set_pairs(u2, i2)
    _assert_csr(t, j)
    for user in (0, 7, 49):
        np.testing.assert_array_equal(t.seen_items(user), j.seen_items(user))
    users = np.asarray([3, 3, 0, 49, 12])
    np.testing.assert_array_equal(t._rows(users).numpy(), np.asarray(j._rows(users)))
    # a checkpointed CSR of fewer users grows to num_users
    j2, t2 = jease.EASE(60, 20), EASE(60, 20, device="cpu")
    for m in (j2, t2):
        m.seed_csr(j.user_ptr, j.item_idx)
    _assert_csr(t2, j2)
    assert len(t2.user_ptr) == 61
    assert not t2._rows(np.asarray([55])).any()


@pytest.mark.parametrize("user_chunk", [7, 50])
def test_gram_bit_for_bit(monkeypatch, user_chunk):
    grams, solve = [], jease._solve_b
    monkeypatch.setattr(jease, "_solve_b", lambda g, lam, exact=True: grams.append(np.asarray(g)) or solve(g, lam,
                                                                                                          exact))
    u, i = _pairs()
    j, t = _both()
    j.fit(u, i, user_chunk=user_chunk)
    t._set_pairs(u, i)
    g = t.gram(user_chunk)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(g.numpy(), grams[0])


def test_b_matches_the_exact_and_iterative_solves():
    u, i = _pairs(n=500, n_users=60, n_items=25, seed=2)
    want = {s: jease.EASE(60, 25, lam=10.0).fit(u, i, solve=s).b for s in ("exact", "iterative")}
    got = {s: EASE(60, 25, lam=10.0, device="cpu").fit(u, i, solve=s).b for s in ("exact", "iterative", "auto")}
    np.testing.assert_allclose(got["exact"].numpy(), np.asarray(want["exact"]), rtol=B_RTOL, atol=B_ATOL)
    for ref in (want["iterative"], want["exact"]):
        np.testing.assert_allclose(got["iterative"].numpy(), np.asarray(ref), rtol=IT_RTOL, atol=IT_ATOL)
    # pinned: "auto" is the exact solve off a TPU, whatever the catalog size
    assert torch.equal(got["auto"], got["exact"])
    assert torch.equal(torch.diagonal(got["exact"]), torch.zeros(25)) and tease._EXACT_INV_MAX_N == 8192
    with pytest.raises(ValueError, match="solve must be"):
        EASE(60, 25, device="cpu").fit(u, i, solve="lu")


def test_newton_schulz_reports_its_iterations():
    u, i = _pairs(n=500, n_users=60, n_items=25, seed=2)
    t = EASE(60, 25, lam=10.0, device="cpu")
    t._set_pairs(u, i)
    a = t.gram()
    a.diagonal().add_(10.0)
    x, k = tease._inv_spd_newton(a, 10.0)
    assert 0 < k <= 60
    torch.testing.assert_close(a @ x, torch.eye(25), rtol=0, atol=1e-4)


def test_scores_predict_and_similarity_match_jax():
    u, i = _pairs()
    j, t = _both()
    j.fit(u, i)
    t.fit(u, i)
    users = np.arange(50)
    np.testing.assert_allclose(t.scores(users).numpy(), np.asarray(j.scores(users)), rtol=1e-5, atol=1e-5)
    for user in (0, 5, 17, 49):
        for excl in (True, False):
            np.testing.assert_array_equal(t.predict(user, top_k=8, exclude_seen=excl),
                                          np.asarray(j.predict(user, top_k=8, exclude_seen=excl)))
    for item in (0, 3, 19):
        np.testing.assert_array_equal(t.get_similarity(item, top_k=6), np.asarray(j.get_similarity(item, top_k=6)))
    with pytest.raises(RuntimeError, match="call fit"):
        EASE(5, 5, device="cpu").scores(np.arange(2))


def test_a_user_without_rows_gets_the_lowest_ids():
    """All-zero scores: the top-k is the lowest item ids, as lax.top_k's."""
    u, i = _pairs()
    keep = u != 11
    j, t = _both()
    j.fit(u[keep], i[keep])
    t.fit(u[keep], i[keep])
    assert not t.scores(np.asarray([11])).any()
    np.testing.assert_array_equal(t.predict(11, top_k=7), np.arange(7))
    np.testing.assert_array_equal(np.asarray(j.predict(11, top_k=7)), np.arange(7))
    vals, ids = tease.topk_rows(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 4)
    assert ids.tolist() == [[1, 2, 4, 3]] and vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def _facades(data=None, **kw):
    data = _data() if data is None else data
    j = JRecSys(dict(data), n_factors=8, net_type="ease", **kw)
    t = RecSys(dict(data), n_factors=8, net_type="ease", device="cpu", **kw)
    return j, t


def test_facade_fits_evaluates_predicts_like_jax():
    j, t = _facades(ease_lam=5.0)
    assert t.model is None and t.ease is not None and t.ease.lam == 5.0
    with pytest.raises(RuntimeError, match="call fit"):
        t.predict(t.store.user_encoder.to_list()[0])
    assert t.fit() == [] and j.fit(verbose=False) == []
    np.testing.assert_allclose(t.ease.b.numpy(), np.asarray(j.ease.b), rtol=B_RTOL, atol=B_ATOL)
    assert t.evaluate(eval_metrics=METRICS) == j.evaluate(eval_metrics=METRICS)
    for bad in (("loss",), ("recall@10", "auc")):
        with pytest.raises(ValueError, match="no pairwise loss"):
            t.evaluate(eval_metrics=bad)
    users = t.store.user_encoder.to_list()
    for excl in (False, True):
        np.testing.assert_array_equal(t.predict(users[3], top_k=6, exclude_seen=excl),
                                      j.predict(users[3], top_k=6, exclude_seen=excl))
        np.testing.assert_array_equal(t.predict(users[:20], top_k=6, exclude_seen=excl),
                                      j.predict(users[:20], top_k=6, exclude_seen=excl))
        np.testing.assert_array_equal(t.predict(users[:5], top_k=6, exclude_seen=excl, return_raw_ids=False),
                                      j.predict(users[:5], top_k=6, exclude_seen=excl, return_raw_ids=False))
    items = t.store.item_encoder.to_list()
    for item in items[:4]:
        got = t.similar_items(item, top_k=5)
        np.testing.assert_array_equal(got, j.similar_items(item, top_k=5))
        assert item not in got
    for export in (t.item_vectors, t.user_vectors):
        with pytest.raises(ValueError, match="no factor vectors"):
            export()
    for install in (t.init_tables, lambda: t.load_jax_tables({})):
        with pytest.raises(ValueError, match="no tables"):
            install()


def test_build_model_refuses_ease_like_jax():
    t = RecSys(_data(), n_factors=8, device="cpu")
    with pytest.raises(ValueError, match=r"unknown net_type 'ease'.*plus 'ease' via"):
        build_model(t.store.schema, ModelConfig(net_type="ease"))


def test_save_load_and_a_jax_checkpoint(tmp_path):
    j, t = _facades(ease_lam=5.0)
    j.fit(verbose=False)
    t.fit()
    users = t.store.user_encoder.to_list()[:12]
    d = str(tmp_path / "port")
    t.save(d)
    state = torch.load(os.path.join(d, "state.pt"), weights_only=True)
    assert sorted(state) == ["b"] and state["b"].shape == (40, 40)
    cold = RecSys.load(d, device="cpu")
    assert cold.model is None and cold.trainer is None and cold.state is None
    assert cold.ease.lam == 100.0  # pinned: JAX's cold load takes EASE's default lam (api.py:782)
    assert torch.equal(cold.ease.b, t.ease.b)
    _assert_csr(cold.ease, t.ease)
    np.testing.assert_array_equal(cold.predict(users, top_k=5), t.predict(users, top_k=5))
    with pytest.raises(ValueError, match="cold RecSys.load"):
        cold.predict(users, top_k=5, exclude_seen=True)
    warm = RecSys(_data(), n_factors=8, net_type="ease", device="cpu")
    warm.restore(d)
    assert torch.equal(warm.ease.b, t.ease.b)
    other = RecSys(_data(n_items=30), n_factors=8, net_type="ease", device="cpu")
    with pytest.raises(ValueError, match="checkpoint b"):
        other.restore(d)
    # JAX save -> JAX cold load -> checkpoint_from_jax -> the port's cold load
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "from_jax")
    j.save(jd)
    jcold = JRecSys.load(jd)
    assert jcold.ease.lam == 100.0
    with open(os.path.join(jd, "schema.json")) as f:
        schema = json.load(f)
    checkpoint_from_jax(pd, {"b": np.asarray(jcold.ease.b)}, jload_aux(jd), schema)
    pcold = RecSys.load(pd, device="cpu")
    np.testing.assert_array_equal(pcold.ease.b.numpy(), np.asarray(jcold.ease.b))
    _assert_csr(pcold.ease, jcold.ease)
    np.testing.assert_array_equal(pcold.predict(users, top_k=5), jcold.predict(users, top_k=5))


def test_update_data_requires_a_refit_then_matches_jax():
    j, t = _facades()
    j.fit(verbose=False)
    t.fit()
    new = {"user_id": np.asarray([1, 8, 999, 999]), "item_id": np.asarray([2, 5, 2, 777])}
    j.update_data(dict(new))
    t.update_data(dict(new))
    assert t.ease.b is None and t.ease.num_items == 41 and t.ease.num_users == t.store.schema.num_users
    with pytest.raises(RuntimeError, match="call fit"):
        t.predict(t.store.user_encoder.to_list()[0])
    j.fit(verbose=False)
    t.fit()
    _assert_csr(t.ease, j.ease)
    np.testing.assert_allclose(t.ease.b.numpy(), np.asarray(j.ease.b), rtol=B_RTOL, atol=B_ATOL)
    np.testing.assert_array_equal(t.predict([999, 1], top_k=4), j.predict([999, 1], top_k=4))


def test_cold_load_then_update_data_keeps_the_original_interactions(tmp_path):
    """tests/test_models.py:193-224 in the port: the checkpointed CSR
    merges with the increment, so a cold model refitted after update_data
    equals a warm twin that saw both."""
    r = np.random.default_rng(1)
    base = {"user_id": r.integers(0, 30, 300), "item_id": r.integers(0, 15, 300)}
    inc = {"user_id": np.asarray([100] * 4), "item_id": np.asarray([0, 1, 2, 3])}
    rs = RecSys(dict(base), n_factors=8, net_type="ease", split_ratio=1.0, device="cpu")
    rs.fit()
    d = str(tmp_path / "ease_cold")
    rs.save(d)
    cold = RecSys.load(d, device="cpu")
    cold.update_data(dict(inc), split_ratio=1.0)
    cold.fit()
    warm = RecSys(dict(base), n_factors=8, net_type="ease", split_ratio=1.0, device="cpu")
    warm.fit()
    warm.update_data(dict(inc), split_ratio=1.0)
    warm.fit()
    np.testing.assert_allclose(cold.ease.b.numpy(), warm.ease.b.numpy(), rtol=B_RTOL, atol=B_ATOL)
    assert cold.ease.nnz == warm.ease.nnz
    jrs = JRecSys(dict(base), n_factors=8, net_type="ease", split_ratio=1.0)
    jrs.fit(verbose=False)
    jd = str(tmp_path / "jax_cold")
    jrs.save(jd)
    jcold = JRecSys.load(jd)
    jcold.update_data(dict(inc), split_ratio=1.0)
    jcold.fit(verbose=False)
    _assert_csr(cold.ease, jcold.ease)
    np.testing.assert_allclose(cold.ease.b.numpy(), np.asarray(jcold.ease.b), rtol=B_RTOL, atol=B_ATOL)


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Gram's TF32 tensor-core product runs only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_gram_is_exact_and_b_tracks_the_cpu(cuda_device):
    u, i = _pairs(n=20000, n_users=3000, n_items=700, seed=3)
    cpu = EASE(3000, 700, lam=10.0, device="cpu").fit(u, i, user_chunk=512)
    card = EASE(3000, 700, lam=10.0, device=cuda_device)
    card._set_pairs(u, i)
    assert torch.equal(card.gram(512).cpu(), cpu.gram(512))
    card.fit(u, i, user_chunk=512)
    torch.testing.assert_close(card.b.cpu(), cpu.b, rtol=B_RTOL, atol=B_ATOL)
    users = np.arange(0, 3000, 37)
    np.testing.assert_array_equal(card.predict(5, top_k=20), cpu.predict(5, top_k=20))
    torch.testing.assert_close(card.scores(users).cpu(), cpu.scores(users), rtol=1e-5, atol=1e-5)

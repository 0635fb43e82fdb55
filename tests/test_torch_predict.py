"""The serving slice end to end: a JAX ``RecSys`` and a port ``RecSys`` on
the same data, the port serving the JAX tables carried over through
``torchrecsys_tpu_torch/utils/convert.py``.

Tables come from the JAX trainer's ``init_state`` (no fitting), with
random biases written into both so the bias path is exercised. Scores are
f32 sums taken in another order by the two packages: vectors and scores
are held within rtol=1e-5, atol=1e-6; the seeded data below has no score
gaps that small among the compared ranks, so ids are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu import RecSys as JRecSys
from torchrecsys_tpu.config import TrainConfig
from torchrecsys_tpu.eval import predict as jpred
from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.eval import predict as tpred
from torchrecsys_tpu_torch.ops.dot_topk import pack_seen_mask
from torchrecsys_tpu_torch.utils.convert import tables_from_jax

RTOL, ATOL = 1e-5, 1e-6
N_FACTORS = 16


def _data(str_ids=False, n=4000, n_users=150, n_items=600, seed=0):
    r = np.random.default_rng(seed)
    users = r.integers(0, n_users, n)
    items = r.integers(0, n_items, n)
    cats = np.empty(n, dtype=object)
    cats[:] = [[int(i % 9), int(i % 4) + 20][: 1 + int(i % 2)] for i in items]
    if str_ids:
        users = np.asarray([f"u{u}" for u in users], dtype=object)
        items = np.asarray([f"item/{i}" for i in items], dtype=object)
    return {"user_id": users, "item_id": items, "category_ids": cats}


def _pair(str_ids=False, use_amp=False):
    data = _data(str_ids)
    kw = dict(metadata_id_col=["category_ids"], n_factors=N_FACTORS, seed=3, use_amp=use_amp)
    jrs = JRecSys(data, **kw)
    jrs._ensure_trainer(TrainConfig(seed=3))
    state = jrs.trainer.init_state(jax.random.PRNGKey(3))
    r = np.random.default_rng(7)
    for name in ("item_bias", "user_bias"):
        shape = state["tables"][name].shape
        state["tables"][name] = jnp.asarray(r.normal(size=shape).astype(np.float32) * 0.1)
    jrs.state = state
    trs = RecSys(data, device="cpu", **kw)
    trs.load_jax_tables({k: np.asarray(v) for k, v in state["tables"].items()})
    return jrs, trs


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _users(rs, count=24):
    return rs.store.user_encoder.to_list()[:count]


@pytest.mark.parametrize("top_k", [10, 64])
@pytest.mark.parametrize("exclude_seen", [False, True])
def test_predict_same_raw_ids(pair, top_k, exclude_seen):
    jrs, trs = pair
    users = _users(jrs)
    want = jrs.predict(users, top_k=top_k, exclude_seen=exclude_seen)
    got = trs.predict(users, top_k=top_k, exclude_seen=exclude_seen)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # a scalar user, encoded rows, and a top_k larger than the catalog
    np.testing.assert_array_equal(
        trs.predict(users[0], top_k=top_k, return_raw_ids=False),
        jrs.predict(users[0], top_k=top_k, return_raw_ids=False),
    )
    np.testing.assert_array_equal(
        trs.predict(users[:3], top_k=5000, exclude_seen=exclude_seen),
        jrs.predict(users[:3], top_k=5000, exclude_seen=exclude_seen),
    )


def test_string_ids_and_similar_items():
    jrs, trs = _pair(str_ids=True)
    users = _users(jrs, 10)
    np.testing.assert_array_equal(trs.predict(users, top_k=10), jrs.predict(users, top_k=10))
    for item in jrs.store.item_encoder.to_list()[:5]:
        np.testing.assert_array_equal(trs.similar_items(item, top_k=7), jrs.similar_items(item, top_k=7))


def test_similar_items(pair):
    jrs, trs = pair
    for item in jrs.store.item_encoder.to_list()[:6]:
        for k in (10, 40):
            np.testing.assert_array_equal(trs.similar_items(item, top_k=k), jrs.similar_items(item, top_k=k))


def test_factor_vectors(pair):
    jrs, trs = pair
    for got, want in zip(trs.item_vectors(), jrs.item_vectors()):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for ids in (None, _users(jrs, 5)):
        for got, want in zip(trs.user_vectors(ids), jrs.user_vectors(ids)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert trs.config == jrs.config


def test_generic_scorer_matches_fused_and_jax(pair):
    """full_catalog_topk (plain chunked scoring through model.score) against
    the fused path and against the JAX generic scorer, with a seen mask."""
    jrs, trs = pair
    rows = np.arange(12)
    feat = trs.feat
    params = trs._params()
    seen = trs._seen(rows)
    mask = torch.from_numpy(pack_seen_mask(seen, 600))
    gv, gi = tpred.full_catalog_topk(
        trs.model, params, {}, torch.from_numpy(rows), 600, feat, top_k=20,
        chunk_size=64, seen_mask=mask,
    )
    fv, fi = tpred._fused_catalog_topk(trs.model, params, torch.from_numpy(rows), 600, feat, 20, seen_mask=mask)
    np.testing.assert_array_equal(gi.numpy(), fi.numpy())
    np.testing.assert_allclose(gv.numpy(), fv.numpy(), rtol=RTOL, atol=ATOL)
    jparams = {"tables": jrs.state["tables"], "dense": jrs.state["dense"]}
    jv, ji = jpred.full_catalog_topk(
        jrs.model, jparams, jrs.state["model_state"], jnp.asarray(rows, jnp.int32), 600,
        jrs.trainer.feature_tables(jrs.store), top_k=20, chunk_size=64,
        seen_mask=jnp.asarray(mask.numpy()),
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)


def test_ranking_eval_matches(pair):
    jrs, trs = pair
    ks = (5, 20)
    jparams = {"tables": jrs.state["tables"], "dense": jrs.state["dense"]}
    want = jpred.ranking_eval(
        jrs.model, jparams, jrs.state["model_state"], jrs.store.test_users,
        jrs.store.test_items, 600, jrs.trainer.feature_tables(jrs.store), ks=ks,
    )
    got = tpred.ranking_eval(
        trs.model, trs._params(), {}, trs.store.test_users, trs.store.test_items,
        600, trs.feat, ks=ks, device=trs.device,
    )
    assert got.keys() == want.keys()
    for m in want:
        assert got[m] == pytest.approx(want[m], rel=1e-12), m


def test_amp_fused_scores_match():
    """use_amp keeps the factor vectors bf16 in both packages; products are
    exact in f32, so scores agree within the f32 tolerance."""
    jrs, trs = _pair(use_amp=True)
    rows = np.arange(10)
    jparams = {"tables": jrs.state["tables"], "dense": jrs.state["dense"]}
    jv, ji = jpred._fused_catalog_topk(
        jrs.model, jparams, jnp.asarray(rows, jnp.int32), 600,
        jrs.trainer.feature_tables(jrs.store), 10,
    )
    tv, ti = tpred._fused_catalog_topk(trs.model, trs._params(), torch.from_numpy(rows), 600, trs.feat, 10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_patch_and_filter_seen_match():
    r = np.random.default_rng(0)
    ids = np.stack([r.permutation(30)[:12] for _ in range(4)]).astype(np.int32)
    # rows keep 12, 9+, 2 (a short row: tail filled) and 6+ candidates
    seen = [np.zeros(0, np.int64), np.unique(r.integers(0, 30, 3)),
            np.sort(ids[2, :10]), np.unique(r.integers(0, 30, 6))]
    np.testing.assert_array_equal(
        RecSys._filter_seen(ids, seen, 5), JRecSys._filter_seen(ids, seen, 5)
    )
    short = [np.arange(27), np.arange(3)]
    np.testing.assert_array_equal(
        RecSys._patch_short_unseen_rows(ids[:2].copy(), short, 30),
        JRecSys._patch_short_unseen_rows(ids[:2].copy(), short, 30),
    )
    with pytest.raises(ValueError, match="entire catalog"):
        RecSys._patch_short_unseen_rows(ids[:1].copy(), [np.arange(30)], 30)


def test_carry_over_checks_tables(pair):
    jrs, trs = pair
    tables = {k: np.asarray(v) for k, v in jrs.state["tables"].items()}
    with pytest.raises(ValueError, match="names"):
        tables_from_jax({k: v for k, v in tables.items() if k != "user"}, trs.model, "cpu")
    with pytest.raises(ValueError, match="shape"):
        tables_from_jax({**tables, "item": tables["item"][:64]}, trs.model, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        tables_from_jax({**tables, "item": tables["item"].astype(np.float64)}, trs.model, "cpu")


def test_errors():
    data = _data()
    for net in ("lstm", "sasrec"):  # the sequence nets build (ROADMAP.md §A item 10)
        seq = RecSys(data, net_type=net, device="cpu", n_factors=4, history_len=3)
        assert seq.model.name == net and seq.feat["hist_ids"].shape == (seq.store.schema.num_users, 3)
    with pytest.raises(ValueError, match="divisible by sasrec_heads"):
        RecSys(data, net_type="sasrec", device="cpu", n_factors=5)
    ease = RecSys(data, net_type="ease", device="cpu")  # EASE builds directly (ROADMAP.md §A item 11)
    assert ease.model is None and ease.ease.num_items == ease.store.schema.num_items
    assert RecSys(data, net_type="fm", device="cpu", n_factors=4).model.name == "fm"
    assert RecSys(data, net_type="neucf", device="cpu", n_factors=4).model.name == "neucf"
    trs = RecSys(data, device="cpu", n_factors=4)
    with pytest.raises(RuntimeError, match="load_jax_tables"):
        trs.predict(0)
    trs.init_tables()
    assert trs.predict([0, 1], top_k=3).shape == (2, 3)
    with pytest.raises(KeyError, match="unknown user_id"):
        trs.predict("nobody")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RecSys(data)

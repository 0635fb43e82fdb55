"""HSTU on the port (torchrecsys_tpu_torch/models/hstu.py, models/sequence.py)
against the plain reference tests/plain_hstu.py, on seeded random weights
of order one (the published init, N(0, 0.02^2), keeps every SiLU in its
linear part), at d = 8, L = 6, 2 blocks of 2 heads. The JAX package has no
HSTU, so nothing here imports JAX: ``python -m pytest --noconftest -m gpu
-s tests/test_torch_hstu.py`` runs the card's test where JAX is not.

Tolerances:

- f32 encodings, scores and one-step gradients: rtol=1e-5, atol=2e-6. The
  port and the reference take the same products in another association
  (the norms' ``rsqrt`` against ``1 / sqrt``, ``SiLU * (1 / L)`` against
  ``SiLU / L``, R built by views against an index gather): an ulp each,
  grown through two blocks of weights of order one to ~1e-6 on unit-norm
  outputs.
- f32 steps: the tables, accumulators and dense leaves after three adam
  steps within rtol=1e-4, atol=1e-6: adam divides each gradient by its own
  running magnitude, so a leaf whose gradient is near nought turns the
  ulps above into steps of up to the learning rate's order; the losses
  within rtol=1e-6.
- bf16 compute: each unit-norm user vector within 0.2 of the f32
  reference and their median within 2e-2. bf16 keeps 8 bits (0.4% a
  rounding); over two blocks of ~10 roundings the median row lands near
  0.5%, and a row whose last state nearly cancels before its L2 norm
  amplifies its rounding by the cancellation.
"""

import numpy as np
import pytest
import torch

from torchrecsys_tpu_torch import RecSys
from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.data.features import attach_features
from torchrecsys_tpu_torch.models import build_model, hstu
from torchrecsys_tpu_torch.ops import hstu_attention as ha
from torchrecsys_tpu_torch.ops import layer_norm as ln
from torchrecsys_tpu_torch.train import Trainer
from torchrecsys_tpu_torch.utils import profiling

import plain_hstu as ph  # tests/ is on sys.path under pytest; another installed "tests" package may shadow ours

D, L, BLOCKS, HEADS = 8, 6, 2, 2
RTOL, ATOL = 1e-5, 2e-6


def _data(n=500, n_users=70, n_items=60, seed=0):
    """Users with a few to many interactions: full, partial and (users whose
    rows all land in the test split) empty history windows."""
    r = np.random.default_rng(seed)
    users = np.minimum(r.geometric(0.04, n) - 1, n_users - 1)
    return {"user_id": users, "item_id": r.integers(0, n_items, n)}


def _model(store=None, compute="float32", **kw):
    store = store or prepare_data(_data(), "user_id", "item_id")
    cfg = dict(net_type="hstu", n_factors=D, history_len=L, hstu_blocks=BLOCKS, hstu_heads=HEADS,
               compute_dtype=compute)
    cfg.update(kw)
    return build_model(store.schema, ModelConfig(**cfg))


def _seeded_dense(model, seed=0, scale=0.5):
    """The model's dense tree with every leaf drawn N(0, scale^2)."""
    g = torch.Generator().manual_seed(seed)
    flat = {k: torch.randn(v.shape, generator=g) * scale for k, v in ph.flatten(model.init_dense(g)).items()}
    return ph.rebuild(model.init_dense(g), flat)


def _histories(kind, b=48, seed=1):
    """(B, L, d) rows and a (B, L) mask: left-padded windows, holes inside
    the window, or every row empty but one."""
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((b, L, D), generator=g) * 0.5
    pos = torch.arange(L)
    if kind == "left_padded":
        mask = pos[None] >= torch.randint(0, L, (b, 1), generator=g)
    elif kind == "interleaved":
        mask = torch.rand((b, L), generator=g) > 0.4
        mask[:, -1] = torch.rand((b,), generator=g) > 0.5
    else:
        mask = torch.zeros((b, L), dtype=torch.bool)
        mask[0] = True
    return emb, mask


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["left_padded", "interleaved", "empty"])
def test_encode_matches_plain_f32(kind):
    model = _model()
    dense = _seeded_dense(model)
    emb, mask = _histories(kind)
    got = model._encode(dense, emb, mask)
    want = ph.encode(dense, emb, mask, HEADS)
    assert got.shape == (48, D) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    empty = ~mask.any(dim=1)
    assert not got[empty].any()  # an empty history encodes to zeros
    torch.testing.assert_close(got[~empty].norm(dim=-1), torch.ones(int((~empty).sum())), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["left_padded", "interleaved", "empty"])
def test_encode_in_bf16_tracks_plain_f32(kind):
    model = _model(compute="bfloat16")
    dense = _seeded_dense(model)
    emb, mask = _histories(kind)
    got = model._encode(dense, emb, mask)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    want = ph.encode(dense, emb, mask, HEADS)
    gaps = (got.float() - want).norm(dim=-1)
    assert float(gaps.max()) <= 0.2 and float(gaps.median()) <= 2e-2, (float(gaps.max()), float(gaps.median()))
    assert not got[~mask.any(dim=1)].float().any()


def test_relative_bias_depends_only_on_the_offset():
    w = torch.randn(2 * L - 1)
    r = hstu.relative_bias(w, L)
    i = torch.arange(L)
    assert torch.equal(r, w[i[None, :] - i[:, None] + L - 1])
    for off in range(-(L - 1), L):
        diag = torch.diagonal(r, offset=off)
        assert torch.equal(diag, torch.full_like(diag, float(w[off + L - 1])))
    # a shorter window centres on its own length, as the published code does
    assert torch.equal(hstu.relative_bias(w, 3), ph.relative_bias(w[:5], 3))
    # one gradient per offset: the sum over that diagonal
    w.requires_grad_()
    g = torch.randn(L, L)
    (grad,) = torch.autograd.grad((hstu.relative_bias(w, L) * g).sum(), w)
    want = torch.stack([torch.diagonal(g, offset=off).sum() for off in range(-(L - 1), L)])
    torch.testing.assert_close(grad, want)


def test_a_later_position_does_not_move_an_earlier_state():
    model = _model()
    dense = _seeded_dense(model)
    emb, mask = _histories("interleaved")
    base = model.states(dense, emb, mask)
    for t in range(L - 1):
        moved = emb.clone()
        moved[:, t + 1:] += torch.randn_like(moved[:, t + 1:])
        shifted_mask = mask.clone()
        shifted_mask[:, t + 1:] = ~shifted_mask[:, t + 1:]  # later keys valid or not: no matter
        got = model.states(dense, moved, shifted_mask)
        assert torch.equal(got[:, : t + 1], base[:, : t + 1]), t
        assert not torch.equal(got[:, t + 1:], base[:, t + 1:])


def test_padding_is_inert():
    model = _model()
    dense = _seeded_dense(model)
    emb, mask = _histories("interleaved")
    junk = emb.clone()
    junk[~mask] = torch.randn(int((~mask).sum()), D) * 10
    states = model.states(dense, emb, mask)
    assert torch.equal(model.states(dense, junk, mask), states)
    assert not states[~mask].any()
    assert torch.equal(model._encode(dense, junk, mask), model._encode(dense, emb, mask))
    # nothing flows back into padded rows either
    junk.requires_grad_()
    (g,) = torch.autograd.grad(model._encode(dense, junk, mask).sum(), junk)
    assert not g[~mask].any() and torch.isfinite(g).all()


def test_dense_tree_init_and_heads_must_divide():
    model = _model(history_len=7, hstu_blocks=3, n_factors=50, hstu_heads=2)
    dense = model.init_dense(torch.Generator().manual_seed(0))
    assert set(model.table_specs()) == {"item", "item_bias"} and tuple(dense["pos"].shape) == (7, 50)
    assert len(dense["blocks"]) == 3
    blk = dense["blocks"][0]
    assert set(blk) == {"uvqk", "o", "rab_pos"} and set(blk["uvqk"]) == {"w"}
    assert tuple(blk["uvqk"]["w"].shape) == (50, 200) and tuple(blk["rab_pos"].shape) == (13,)
    assert tuple(blk["o"]["w"].shape) == (50, 50) and not blk["o"]["b"].any()
    assert abs(float(blk["uvqk"]["w"].std()) - 0.02) < 2e-3
    assert float(blk["o"]["w"].abs().max()) <= (6 / 100) ** 0.5
    cfg = ModelConfig(net_type="hstu")
    assert (cfg.hstu_blocks, cfg.hstu_heads) == (2, 1)
    with pytest.raises(ValueError, match="divisible by hstu_heads=3"):
        _model(hstu_heads=3)


# ---------------------------------------------------------------------------
# scoring sides
# ---------------------------------------------------------------------------


def _tables(store, seed=3):
    g = torch.Generator().manual_seed(seed)
    n = store.schema.num_items
    return {"item": torch.randn((n, D), generator=g) * 0.3, "item_bias": torch.randn((n, 1), generator=g) * 0.1}


def _trainer(model, **kw):
    cfg = dict(loss="logistic", dense_optimizer="adam", learning_rate=0.01, batch_size=40)
    cfg.update(kw)
    return Trainer(model, TrainConfig(**cfg), "cpu")


@pytest.mark.parametrize("k", [0, 1, 3], ids=["generic", "paired_k1", "paired_k3"])
def test_score_rows_match_plain(k):
    store = prepare_data(_data(), "user_id", "item_id")
    model = _model(store)
    dense, tables = _seeded_dense(model), _tables(store)
    tr = _trainer(model)
    feat = tr.feature_tables(store)
    r = np.random.default_rng(2)
    b, n_items = 40, store.schema.num_items
    users = torch.as_tensor(r.integers(0, store.schema.num_users, b))
    hist_ids, hist_mask = feat["hist_ids"][users], feat["hist_mask"][users]
    # positives from each user's own history: the leakage mask bites
    pos = torch.where(hist_mask[:, -1], hist_ids[:, -1], torch.as_tensor(r.integers(0, n_items, b)))
    if k == 0:
        side = attach_features({"user_id": users, "item_id": pos}, feat)
    else:
        negs = hist_ids[:, :k].T.contiguous() if k > 1 else hist_ids[:, 0]  # negatives inside the history
        side = tr._paired_side(users, pos, negs, feat)
        assert side["_pair_b"] == b and model.gathers(side)["hist"][1].shape == (b, L)
    got, _ = model.score({"tables": tables, "dense": dense}, {}, side)
    # every row hides the positive of its pair (the generic side: its own candidate)
    mask = hist_mask & (hist_ids != pos[:, None])
    h = ph.encode(dense, tables["item"][hist_ids], mask, HEADS)
    items = side["item_id"]
    want = (h.repeat(items.shape[0] // b, 1) * tables["item"][items]).sum(-1) + tables["item_bias"][items, 0]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_pair_vectors_match_plain():
    store = prepare_data(_data(), "user_id", "item_id")
    model = _model(store)
    dense, tables = _seeded_dense(model), _tables(store)
    feat = _trainer(model).feature_tables(store)
    users = torch.as_tensor(np.asarray(store.train_users[:48])).long()
    items = torch.as_tensor(np.asarray(store.train_items[:48])).long()
    side = attach_features({"user_id": users, "item_id": items}, feat)
    h, v, vb, _ = model.pair_vectors(dense, {}, model.gather_rows(tables, side), side, train=True)
    hist_ids, hist_mask = feat["hist_ids"][users], feat["hist_mask"][users]
    want = ph.encode(dense, tables["item"][hist_ids], hist_mask & (hist_ids != items[:, None]), HEADS)
    torch.testing.assert_close(h, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(v, tables["item"][items])
    torch.testing.assert_close(vb, tables["item_bias"][items, 0])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _state(model, tables, dense):
    from torchrecsys_tpu_torch.train.optim import init_embedding_opt

    return {"tables": {k: v.clone() for k, v in tables.items()},
            "dense": ph.rebuild(dense, {k: v.clone() for k, v in ph.flatten(dense).items()}),
            "model_state": {}, "emb_opt": init_embedding_opt("rowwise_adagrad", tables), "dense_opt": None,
            "step": 0}


def _batches(store, n=3, b=40, seed=4):
    r = np.random.default_rng(seed)
    users, items = np.asarray(store.train_users), np.asarray(store.train_items)
    out = []
    for _ in range(n):
        rows = r.choice(len(users), b, replace=False)
        pos = torch.as_tensor(items[rows]).long()
        neg = (pos + torch.as_tensor(r.integers(1, store.schema.num_items, b))) % store.schema.num_items
        out.append({"user": torch.as_tensor(users[rows]).long(), "pos": pos, "neg": neg})
    return out


def test_three_logistic_steps_with_adam_match_plain():
    """Losses, the first step's gradients (rowwise adagrad's accumulators
    after it; adam's first moment over 1 - beta1 for every dense leaf) and
    every parameter after the third step."""
    store = prepare_data(_data(), "user_id", "item_id")
    model = _model(store)
    dense, tables = _seeded_dense(model, scale=0.3), _tables(store)
    tr = _trainer(model)
    feat = tr.feature_tables(store)
    batches = _batches(store)
    want = ph.logistic_steps(tables, dense, batches, 0.01, feat["hist_ids"], feat["hist_mask"], HEADS)
    state, losses = _state(model, tables, dense), []
    for i, bt in enumerate(batches):
        state, loss = tr.train_step(state, {"user_id": bt["user"], "pos_item_id": bt["pos"],
                                            "neg_item_id": bt["neg"]}, feat)
        losses.append(float(loss))
        if i == 0:
            for name in ("item", "item_bias"):
                torch.testing.assert_close(state["emb_opt"][name]["acc"], want["first"]["acc"][name],
                                           rtol=RTOL, atol=1e-9)
            mu = ph.flatten(state["dense_opt"]["mu"])
            for path, g in want["first"]["dense"].items():
                torch.testing.assert_close(mu[path] / (1 - ph.ADAM_B1), g, rtol=RTOL, atol=ATOL, msg=path)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-6)
    for name in ("item", "item_bias"):
        torch.testing.assert_close(state["tables"][name], want["tables"][name], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(state["emb_opt"][name]["acc"], want["acc"][name], rtol=1e-4, atol=1e-9)
    got = ph.flatten(state["dense"])
    for path, p in want["dense"].items():
        torch.testing.assert_close(got[path], p, rtol=1e-4, atol=1e-6, msg=path)
        assert not torch.equal(p, ph.flatten(dense)[path]), path  # every leaf moved


def test_one_encode_a_paired_step_and_its_span():
    store = prepare_data(_data(), "user_id", "item_id")
    model = _model(store)
    tr = _trainer(model)
    feat = tr.feature_tables(store)
    state = _state(model, _tables(store), _seeded_dense(model))
    bt = _batches(store, n=1)[0]
    batch = {"user_id": bt["user"], "pos_item_id": bt["pos"], "neg_item_id": bt["neg"]}
    before = profiling.counters()["hstu.encodes"]
    state, _ = tr.train_step(state, batch, feat)
    assert profiling.counters()["hstu.encodes"] - before == 1
    neg2 = torch.stack([bt["neg"], (bt["neg"] + 1) % store.schema.num_items])  # K = 2 draws: still one
    before = profiling.counters()["hstu.encodes"]
    state, _ = tr.train_step(state, dict(batch, neg_item_id=neg2), feat)
    assert profiling.counters()["hstu.encodes"] - before == 1
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("step"):
            tr.train_step(state, batch, feat)
    spans = profiling.spans()
    enc = [s for s in spans if s.name == "hstu.encode"]
    assert len(enc) == 1 and enc[0].end_ns >= enc[0].start_ns
    assert spans[enc[0].root].name == "step"
    profiling.reset()


def test_facade_fits_evaluates_and_predicts_the_plain_ranking():
    data = _data(n=800)
    rs = RecSys(data, net_type="hstu", n_factors=D, history_len=L, seed=3, device="cpu")
    assert rs.model_cfg.hstu_blocks == 2 and rs.model_cfg.hstu_heads == 1
    rs.fit(epochs=2, batch_size=64, loss="logistic", learning_rate=0.02, verbose=False)
    metrics = rs.evaluate(eval_metrics=("loss", "auc", "recall@5"), verbose=False)
    assert set(metrics) == {"loss", "auc", "recall@5"} and all(np.isfinite(list(metrics.values())))
    users = rs.store.user_encoder.to_list()[:12]
    got = rs.predict(users, top_k=7, return_raw_ids=False)
    assert got.shape == (12, 7)
    # the reference's full-catalog ranking of every item for each user's whole window
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users])
    n = rs.store.schema.num_items
    item, bias = rs.state["tables"]["item"][:n], rs.state["tables"]["item_bias"][:n, 0]
    h = ph.encode(rs.state["dense"], item[rs.feat["hist_ids"][rows]], rs.feat["hist_mask"][rows], 1)
    want = torch.topk(h @ item.T + bias, 7, dim=1).indices
    np.testing.assert_array_equal(np.asarray(got), want.numpy())
    vecs, const = rs.user_vectors(users)
    np.testing.assert_allclose(vecs, h.numpy(), rtol=RTOL, atol=ATOL)
    assert not const.any()


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layer-norm and attention kernels run only there")
    return torch.device("cuda")


def _grads(fn, dense, emb, q, dtype):
    """Every dense leaf's and the history rows' gradient of a logistic loss
    on ``fn``'s user vectors against one item each, in ``dtype``."""
    flat = {k: t.detach().to(dtype).requires_grad_() for k, t in ph.flatten(dense).items()}
    hist = emb.detach().to(dtype).requires_grad_()
    h = fn(ph.rebuild(dense, flat), hist)
    loss = torch.nn.functional.softplus(-(h * q.to(dtype)).sum(-1)).mean()
    grads = torch.autograd.grad(loss, [hist] + list(flat.values()))
    return h, dict(zip(["hist"] + list(flat), grads))


def _gap(got, want):
    """||got - want|| / ||want|| in float64."""
    return float((got.detach().double() - want.detach()).norm() / want.detach().norm().clamp_min(1e-300))


@pytest.mark.gpu
def test_encoder_at_the_cell_widths_matches_float64_on_card(cuda_device):
    """d = 50, L = 200, 8 blocks of 2 heads (the benchmark's configuration)
    on 512 histories, ~30% of positions padded, holes, 16 empty: the user
    vectors and every leaf's gradient, port f32 (kernels #8 and #9)
    against the reference in float64, within 1e-6 or twice the reference's
    own f32 gap, whichever is larger. 16 + 16 launches of #8 and 8 + 8 of
    #9 (the attention)."""
    b, length, d = 512, 200, 50
    store = prepare_data({"user_id": np.arange(100) % 10, "item_id": np.arange(100)}, "user_id", "item_id")
    model = build_model(store.schema, ModelConfig(net_type="hstu", n_factors=d, history_len=length,
                                                  hstu_blocks=8, hstu_heads=2)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    dense = model.init_dense(g)
    emb = torch.randn((b, length, d), generator=g, device=cuda_device) / d
    lengths = length - (0.55 * length * torch.rand((b,), generator=g, device=cuda_device)).long()
    lengths[:16] = 0
    mask = torch.arange(length, device=cuda_device)[None] < lengths[:, None]
    mask &= torch.rand((b, length), generator=g, device=cuda_device) > 0.02
    q = torch.randn((b, d), generator=g, device=cuda_device) / d ** 0.5

    with ph.ieee_f32():
        f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
        af0, ab0 = ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches
        h, port = _grads(lambda dn, e: model._encode(dn, e, mask), dense, emb, q, torch.float32)
        torch.cuda.synchronize()
        launches = (ln.layer_norm_fwd.launches - f0, ln.layer_norm_bwd.launches - b0)
        attn_launches = (ha.hstu_attention_fwd.launches - af0, ha.hstu_attention_bwd.launches - ab0)
        h32, plain = _grads(lambda dn, e: ph.encode(dn, e, mask, 2), dense, emb, q, torch.float32)
        h64, ref = _grads(lambda dn, e: ph.encode(dn, e, mask, 2), dense, emb, q, torch.float64)
    assert launches == (16, 16) and attn_launches == (8, 8)
    assert not h[:16].any() and torch.isfinite(h).all()
    gaps = {"h": (_gap(h, h64), _gap(h32, h64))}
    gaps.update({k: (_gap(port[k], ref[k]), _gap(plain[k], ref[k])) for k in ref})
    for k, (gp, gpl) in gaps.items():
        print(f"[hstu] {k}: port {gp:.3e}, plain f32 {gpl:.3e}")
    bad = {k: v for k, v in gaps.items() if v[0] > max(1e-6, 2 * v[1])}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("history_len", [20, 300], ids=["default_window", "window_past_256"])
def test_facade_at_its_default_width_runs_on_card(cuda_device, history_len):
    """RecSys(net_type="hstu") on the card at its defaults: n_factors 80 in
    one head (the facade sets no heads), 2 blocks, the default window of 20
    and one of 300 (past the staged kernels' 256, so both take #9's
    streamed kernels). The fit launches #9 once a block each way a step,
    evaluate and predict run, and the fitted model's user vectors lie
    within max(1e-6, 2 x the plain f32 gap) of the reference's in float64."""
    data = _data(n=800)
    rs = RecSys(data, net_type="hstu", history_len=history_len, seed=3)
    assert rs.model_cfg.n_factors == 80 and rs.model_cfg.hstu_heads == 1 and str(rs.device).startswith("cuda")
    f0, b0 = ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches
    rs.fit(epochs=1, batch_size=64, loss="logistic", learning_rate=0.02, verbose=False)
    steps = -(-rs.store.num_train // 64)
    blocks = rs.model_cfg.hstu_blocks
    assert (ha.hstu_attention_fwd.launches - f0, ha.hstu_attention_bwd.launches - b0) == (blocks * steps,) * 2
    metrics = rs.evaluate(eval_metrics=("loss", "auc", "recall@5"), verbose=False)
    assert all(np.isfinite(list(metrics.values())))
    users = rs.store.user_encoder.to_list()[:12]
    assert np.asarray(rs.predict(users, top_k=7, return_raw_ids=False)).shape == (12, 7)
    vecs, _ = rs.user_vectors(users)
    dev = rs.feat["hist_ids"].device
    rows = torch.as_tensor([rs.store.user_encoder.encode_one(u) for u in users], device=dev)
    item = rs.state["tables"]["item"][: rs.store.schema.num_items]
    hist, mask = item[rs.feat["hist_ids"][rows]], rs.feat["hist_mask"][rows]
    dense = rs.state["dense"]
    with ph.ieee_f32():
        h32 = ph.encode(dense, hist.float(), mask, 1)
        h64 = ph.encode(ph.rebuild(dense, {k: t.double() for k, t in ph.flatten(dense).items()}), hist.double(),
                        mask, 1)
    port, plain = _gap(torch.as_tensor(vecs, device=dev), h64), _gap(h32, h64)
    print(f"[hstu] facade window {history_len}: port {port:.3e}, plain f32 {plain:.3e}")
    assert port <= max(1e-6, 2 * plain), (port, plain)

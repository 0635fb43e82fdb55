"""The port's fused pairwise step (torchrecsys_tpu_torch/ops/fused_pairwise.py)
against the JAX package's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and passed to both packages as
numpy arrays. Random inputs: every output within rtol=1e-5, atol=1e-6
(f32 sums in another order; XLA's CPU rsqrt is an approximation where
torch's is 1/sqrt). bf16 (AMP) inputs: rtol=2e-2, atol=2e-3, the tolerance
the JAX package holds its own AMP paths to (tests/test_fused_pairwise.py:
169-210). Exact-arithmetic inputs (small integers, dyadic weights, power-
of-two scalars and accumulators, so every sum, product and rsqrt is exact
in f32): every output identical, including rows that sit on the hinge's
kink (diff == 0), where half the subgradient goes to each side.

The CUDA kernel itself runs only on a card: the ``gpu`` tests at the end
hold it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.ops import fused_pairwise as jfp
from torchrecsys_tpu_torch.ops import fused_pairwise as tfp

RTOL, ATOL = 1e-5, 1e-6
D = 16


def _rows(b, seed, d=D):
    """Three (b, 128) packed row blocks: normal vectors and biases,
    non-negative accumulators, zero padding."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = np.zeros((b, 128), np.float32)
        x[:, :d] = r.normal(size=(b, d)) * 0.5
        x[:, d] = np.abs(r.normal(size=b))
        x[:, d + 1] = r.normal(size=b) * 0.1
        x[:, d + 2] = np.abs(r.normal(size=b))
        out.append(x)
    return out


def _exact_rows(b, seed, d=D):
    """Small-integer vectors and biases; accumulators in {1, 4, 16}. With
    inv = 2^-14 every mean square stays below half an ulp of its
    accumulator, so each rsqrt argument is a power of four."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = np.zeros((b, 128), np.float32)
        x[:, :d] = r.integers(-2, 3, (b, d))
        x[:, d] = r.choice([1.0, 4.0, 16.0], b)
        x[:, d + 1] = r.integers(-1, 2, b)
        x[:, d + 2] = r.choice([1.0, 4.0, 16.0], b)
        out.append(x)
    return out


def _jax(u, p, n, w, inv, lr, **kw):
    uo, po, no, loss = jfp._pairwise_updates_rows(
        jnp.asarray(u), jnp.asarray(p), jnp.asarray(n),
        None if w is None else jnp.asarray(w), jnp.float32(inv), lr,
        interpret=True, **kw,
    )
    items = None if po is None else np.concatenate([np.asarray(po), np.asarray(no)])
    return np.asarray(uo), items, np.asarray(loss)


def _port(fn, u, p, n, w, inv, lr, **kw):
    uo, items, loss = fn(
        torch.from_numpy(u), torch.from_numpy(p), torch.from_numpy(n),
        None if w is None else torch.from_numpy(w), inv, lr, **kw,
    )
    return uo.numpy(), None if items is None else items.numpy(), loss.numpy()


def _assert_outputs(got, want, rtol=RTOL, atol=ATOL, exact=False):
    for name, g, w in zip(("upd_u", "upd_items", "loss_sum"), got, want):
        if w is None:
            assert g is None, name
        elif exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# (loss, sigmoid, weighted, emit_g, item_upd): every loss with and without
# the sigmoid; weights on and off; the emit_g / item_upd variants spread
# over them
_VARIANTS = [
    ("hinge", False, True, False, True),
    ("hinge", False, False, True, True),
    ("hinge", True, True, True, False),
    ("bpr", False, False, False, True),
    ("bpr", True, True, True, True),
    ("logistic", False, True, True, False),
    ("logistic", True, False, False, True),
]


@pytest.mark.parametrize("loss,sigmoid,weighted,emit_g,item_upd", _VARIANTS)
def test_rows_match_pallas(loss, sigmoid, weighted, emit_g, item_upd):
    b = 64
    u, p, n = _rows(b, seed=len(loss) + 2 * sigmoid + 4 * emit_g)
    w = np.random.default_rng(1).random(b).astype(np.float32) if weighted else None
    inv = float(np.float32(1.0) / np.float32(w.sum())) if weighted else float(np.float32(1 / b))
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=sigmoid, eps=1e-10,
              emit_g=emit_g, item_upd=item_upd)
    want = _jax(u, p, n, w, inv, 0.05, **kw)
    _assert_outputs(_port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw), want)
    # the wrapper on CPU tensors is the plain version, exactly
    _assert_outputs(
        _port(tfp.pairwise_updates_rows_plain, u, p, n, w, inv, 0.05, **kw),
        _port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw),
        exact=True,
    )


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_bf16_rows_match_pallas(loss):
    b = 48
    u, p, n = _rows(b, seed=11)
    w = np.random.default_rng(2).random(b).astype(np.float32)
    inv = float(np.float32(1.0) / np.float32(w.sum()))
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=False, eps=1e-10, bf16=True, emit_g=True)
    _assert_outputs(
        _port(tfp.pairwise_updates_rows, u, p, n, w, inv, 0.05, **kw),
        _jax(u, p, n, w, inv, 0.05, **kw),
        rtol=2e-2, atol=2e-3,
    )


def test_batch_not_multiple_of_8():
    """The TPU wrapper pads B to its tile and weights the filler 0; the
    port needs no padding."""
    b = 37
    u, p, n = _rows(b, seed=5)
    kw = dict(d=D, margin=1.0, loss_kind="bpr", sigmoid=False, eps=1e-10)
    inv = float(np.float32(1 / b))
    _assert_outputs(
        _port(tfp.pairwise_updates_rows, u, p, n, None, inv, 0.05, **kw),
        _jax(u, p, n, None, inv, 0.05, **kw),
    )


def test_exact_inputs_match_pallas_on_the_hinge_kink():
    b = 96
    u, p, n = _exact_rows(b, seed=3)
    # force diff == 0 on a third of the rows: <u, n> + b_n = <u, p> + b_p - 1
    kink = np.arange(0, b, 3)
    n[kink, : D + 3] = p[kink, : D + 3]
    n[kink, D + 1] -= 1.0
    w = np.random.default_rng(4).choice([0.0, 0.5, 1.0], b).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False, eps=0.0, emit_g=True)
    got = _port(tfp.pairwise_updates_rows, u, p, n, w, 2.0**-14, 0.5, **kw)
    _assert_outputs(got, _jax(u, p, n, w, 2.0**-14, 0.5, **kw), exact=True)
    # on the kink the pair's gradient is half the active one
    gp = got[0][kink, D + 4]
    np.testing.assert_array_equal(gp, -0.5 * w[kink] * 2.0**-14)


def test_pack_round_trip_matches_jax():
    r = np.random.default_rng(0)
    vec = r.normal(size=(70, D + 1)).astype(np.float32)
    bias = r.normal(size=(70, 2)).astype(np.float32)
    want = np.asarray(jfp.pack_side(jnp.asarray(vec), jnp.asarray(bias)))
    got = tfp.pack_side(torch.from_numpy(vec), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), want)
    v2, b2 = tfp.unpack_side(got, D)
    np.testing.assert_array_equal(v2.numpy(), vec)
    np.testing.assert_array_equal(b2.numpy(), bias)


def _tables(seed, n_users=30, n_items=25, meta_rows=9):
    r = np.random.default_rng(seed)
    user, item = (np.zeros((k, 128), np.float32) for k in (n_users, n_items))
    for t in (user, item):
        t[:, :D] = r.normal(size=(t.shape[0], D)) * 0.3
        t[:, D] = np.abs(r.normal(size=t.shape[0])) * 0.1
        t[:, D + 1] = r.normal(size=t.shape[0]) * 0.1
    meta = r.normal(size=(meta_rows, D + 1)).astype(np.float32) * 0.3
    meta[:, D] = np.abs(meta[:, D])
    return user, item, meta


@pytest.mark.parametrize("weighted", [False, True])
def test_step_matches_pallas(weighted):
    """fused_pairwise_step: gather -> rows -> index_add_ scatters (with
    duplicate users and items in the batch) and the mean loss."""
    user, item, _ = _tables(0)
    r = np.random.default_rng(1)
    b = 40
    uid, pid, nid = (r.integers(0, k, b) for k in (30, 25, 25))
    w = (np.arange(b) < 33).astype(np.float32) if weighted else None
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False)
    ju, ji, jl = jfp.fused_pairwise_step(
        jnp.asarray(user), jnp.asarray(item), *(jnp.asarray(x, jnp.int32) for x in (uid, pid, nid)),
        None if w is None else jnp.asarray(w), 0.05, interpret=True, **kw,
    )
    tu, ti, tl = tfp.fused_pairwise_step(
        torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
        *(torch.from_numpy(x) for x in (uid, pid, nid)),
        None if w is None else torch.from_numpy(w), 0.05, **kw,
    )
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_meta_step_matches_pallas():
    """fused_pairwise_step_meta (Linear): composite rows, the kernel's
    emitted g lanes, per-feature metadata deltas into the augmented
    (Rf, D+1) table."""
    user, item, meta = _tables(2)
    r = np.random.default_rng(3)
    b = 32
    uid, pid, nid = (r.integers(0, k, b) for k in (30, 25, 25))
    meta_ids = r.integers(0, 9, (25, 1, 3))
    meta_mask = r.random((25, 1, 3)) < 0.7
    w = (np.arange(b) < 29).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind="bpr", sigmoid=False)
    ju, ji, jm, _, jl = jfp.fused_pairwise_step_meta(
        jnp.asarray(user), jnp.asarray(item), (jnp.asarray(meta),), None,
        jnp.asarray(meta_ids, jnp.int32), jnp.asarray(meta_mask),
        *(jnp.asarray(x, jnp.int32) for x in (uid, pid, nid)), jnp.asarray(w), 0.05,
        interpret=True, fm=False, **kw,
    )
    tu, ti, tm, tl = tfp.fused_pairwise_step_meta(
        torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
        [torch.from_numpy(meta.copy())],
        torch.from_numpy(meta_ids), torch.from_numpy(meta_mask),
        *(torch.from_numpy(x) for x in (uid, pid, nid)), torch.from_numpy(w), 0.05, **kw,
    )
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    u, p, n = (torch.from_numpy(x) for x in _rows(8, seed=0))
    kw = dict(margin=1.0, loss_kind="hinge", sigmoid=False, eps=1e-10)
    with pytest.raises(ValueError, match="packed"):
        tfp.pairwise_updates_rows(u[:, :64], p, n, None, 0.1, 0.1, d=D, **kw)
    with pytest.raises(ValueError, match="d=123"):
        tfp.pairwise_updates_rows(u, p, n, None, 0.1, 0.1, d=123, emit_g=True, **kw)
    with pytest.raises(ValueError, match="unsupported loss"):
        tfp.pairwise_updates_rows(u, p, n, None, 0.1, 0.1, d=D, **dict(kw, loss_kind="warp"))


# ---------------------------------------------------------------------------
# the step (on the CPU its plain version) against the JAX step
# ---------------------------------------------------------------------------


def _step_ids(b, n_users, n_items, seed):
    """Batch ids with duplicates: a user on the first 6 rows, an item that
    is the positive and the negative of one row, and one that is a row's
    positive and another row's negative."""
    r = np.random.default_rng(seed)
    uid, pid, nid = r.integers(0, n_users, b), r.integers(0, n_items, b), r.integers(0, n_items, b)
    uid[:6] = uid[0]
    nid[3] = pid[3]
    nid[7] = pid[9]
    return uid, pid, nid


def _jax_step(user, item, ids, w, lr, meta=None, **kw):
    """JAX's fused_pairwise_step / fused_pairwise_step_meta (Pallas in
    interpret mode) -> numpy tables (user, item, meta tables) and loss."""
    jids = tuple(jnp.asarray(x, jnp.int32) for x in ids)
    jw = None if w is None else jnp.asarray(w)
    if meta is None:
        ju, ji, jl = jfp.fused_pairwise_step(jnp.asarray(user), jnp.asarray(item), *jids, jw, lr,
                                             interpret=True, **kw)
        return np.asarray(ju), np.asarray(ji), [], np.asarray(jl)
    tables, mids, mmask = meta
    ju, ji, jm, _, jl = jfp.fused_pairwise_step_meta(
        jnp.asarray(user), jnp.asarray(item), tuple(jnp.asarray(t) for t in tables), None,
        jnp.asarray(mids, jnp.int32), jnp.asarray(mmask), *jids, jw, lr,
        interpret=True, fm=False, **kw,
    )
    return np.asarray(ju), np.asarray(ji), [np.asarray(t) for t in jm], np.asarray(jl)


def _port_step(user, item, ids, w, lr, meta=None, **kw):
    tids = tuple(torch.from_numpy(x) for x in ids)
    tw = None if w is None else torch.from_numpy(w)
    if meta is None:
        tu, ti, tl = tfp.fused_pairwise_step(torch.from_numpy(user.copy()),
                                             torch.from_numpy(item.copy()), *tids, tw, lr, **kw)
        return tu.numpy(), ti.numpy(), [], tl.numpy()
    tables, mids, mmask = meta
    tu, ti, tm, tl = tfp.fused_pairwise_step_meta(
        torch.from_numpy(user.copy()), torch.from_numpy(item.copy()),
        [torch.from_numpy(t.copy()) for t in tables], torch.from_numpy(mids),
        torch.from_numpy(mmask), *tids, tw, lr, **kw,
    )
    return tu.numpy(), ti.numpy(), [t.numpy() for t in tm], tl.numpy()


def _assert_step(got, want, rtol=RTOL, atol=ATOL):
    for name, g, x in zip(("user_pk", "item_pk"), got[:2], want[:2]):
        np.testing.assert_allclose(g, x, rtol=rtol, atol=atol, err_msg=name)
    assert len(got[2]) == len(want[2])
    for f, (g, x) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g, x, rtol=rtol, atol=atol, err_msg=f"meta table {f}")
    np.testing.assert_allclose(got[3], want[3], rtol=rtol, atol=atol, err_msg="loss")


def _meta_tables(seed, n_items=25, widths=(9, 7), w=3):
    """F = len(widths) augmented (rows, D+1) tables, (n_items, F, W) ids
    and masks; item 0 fully masked."""
    r = np.random.default_rng(seed)
    tables = []
    for rows in widths:
        t = (r.normal(size=(rows, D + 1)) * 0.3).astype(np.float32)
        t[:, D] = np.abs(t[:, D])
        tables.append(t)
    mids = np.stack([r.integers(0, rows, (n_items, w)) for rows in widths], axis=1)
    mmask = r.random((n_items, len(widths), w)) < 0.7
    mmask[0] = False
    return tables, mids, mmask


# (loss, sigmoid, weighted): every loss weighted and not, one with the sigmoid
_STEP_CASES = [
    ("hinge", False, False), ("hinge", False, True), ("bpr", False, False), ("bpr", False, True),
    ("logistic", False, False), ("logistic", False, True), ("logistic", True, True),
]


@pytest.mark.parametrize("loss,sigmoid,weighted", _STEP_CASES)
def test_step_cases_match_pallas(loss, sigmoid, weighted):
    """fused_pairwise_step against JAX's: a user repeated over 6 rows, an
    item both the positive and the negative of one row and of two rows,
    zero-weighted filler rows (the trainer's remainder batch) or none.
    Tolerance: rtol=1e-5, atol=1e-6, f32 sums in another order."""
    user, item, _ = _tables(10)
    b = 48
    ids = _step_ids(b, 30, 25, seed=11)
    w = (np.arange(b) < 41).astype(np.float32) if weighted else None
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=sigmoid)
    _assert_step(_port_step(user, item, ids, w, 0.05, **kw), _jax_step(user, item, ids, w, 0.05, **kw))


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_step_bf16_matches_pallas(meta):
    """AMP (bf16 score path) steps at the JAX package's own AMP tolerance,
    rtol=2e-2, atol=2e-3 (its tests/test_fused_pairwise.py:169-210): bf16
    rounds at other places in XLA's step and the port's plain step."""
    user, item, _ = _tables(12)
    b = 40
    ids = _step_ids(b, 30, 25, seed=13)
    w = (np.arange(b) < 35).astype(np.float32)
    m = _meta_tables(14) if meta else None
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False, bf16=True)
    _assert_step(_port_step(user, item, ids, w, 0.05, m, **kw),
                 _jax_step(user, item, ids, w, 0.05, m, **kw), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
def test_meta_step_two_features_three_slots_match_pallas(loss):
    """fused_pairwise_step_meta with F=2, W=3: a fully masked item (its
    composite is its own row), a metadata id shared by a positive and a
    negative, a repeated user. Tolerance: rtol=1e-5, atol=1e-6."""
    user, item, _ = _tables(15)
    tables, mids, mmask = _meta_tables(16)
    b = 36
    uid, pid, nid = _step_ids(b, 30, 25, seed=17)
    pid[0], nid[1] = 0, 0  # the fully masked item, once each side
    pid[2], nid[2] = 3, 4
    mids[3, 0, 0] = mids[4, 0, 1] = 5
    mmask[3, 0, 0] = mmask[4, 0, 1] = True
    w = (np.arange(b) < 30).astype(np.float32)
    kw = dict(d=D, margin=1.0, loss_kind=loss, sigmoid=False)
    m = (tables, mids, mmask)
    _assert_step(_port_step(user, item, (uid, pid, nid), w, 0.05, m, **kw),
                 _jax_step(user, item, (uid, pid, nid), w, 0.05, m, **kw))


def test_skipping_masked_meta_slots_is_exact():
    """The step kernel skips masked metadata slots. In the plain step a
    masked slot's delta is exactly +-0 in every lane (g * 0, msq = +0) and
    its row enters the composite times 0, so adding them or skipping them
    gives the same bits."""
    user, item, _ = _tables(18)
    tables, mids, mmask = _meta_tables(19)
    ids = tuple(torch.from_numpy(x) for x in _step_ids(32, 30, 25, seed=20))
    meta_vec = [torch.from_numpy(t) for t in tables]
    mids_t, mmask_t = torch.from_numpy(mids), torch.from_numpy(mmask)
    *_, meta_deltas, _ = tfp._meta_step_core(
        torch.from_numpy(user), torch.from_numpy(item), meta_vec, mids_t, mmask_t, *ids, None,
        1 / 32, 0.05, d=D, margin=1.0, loss_kind="bpr", sigmoid=False, bf16=False, eps=1e-10,
    )
    iids = torch.cat(ids[1:])
    for f, (slot_ids, delta) in enumerate(meta_deltas):
        keep = mmask_t[iids][:, f, :].reshape(-1)
        assert 0 < int(keep.sum()) < keep.numel()
        assert bool((delta[~keep] == 0).all())
        full = meta_vec[f].clone().index_add_(0, slot_ids, delta)
        skip = meta_vec[f].clone().index_add_(0, slot_ids[keep], delta[keep])
        assert torch.equal(full.view(torch.int32), skip.view(torch.int32))
        # the composite's masked sum: rows times their mask == the unmasked rows
        rows = meta_vec[f][mids_t[iids][:, f, :]][..., :D]
        m = mmask_t[iids][:, f, :]
        masked = torch.sum(rows * m[..., None].float(), dim=1)
        skipped = torch.stack([rows[i][m[i]].sum(0) if m[i].any() else torch.zeros(D)
                               for i in range(len(iids))])
        assert torch.equal(masked, skipped)


@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
def test_step_writes_loss_out_slot(meta):
    """With loss_out the step writes its loss into loss_out[loss_index],
    returns that slot and leaves the other slots alone; the tables move as
    without it."""
    user, item, _ = _tables(21)
    ids = tuple(torch.from_numpy(x) for x in _step_ids(24, 30, 25, seed=22))
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False)
    runs = []
    for loss_out in (None, torch.full((5,), 7.0)):
        tables = [torch.from_numpy(user.copy()), torch.from_numpy(item.copy())]
        extra = dict(loss_out=loss_out, loss_index=2) if loss_out is not None else {}
        if meta:
            mt, mids, mmask = _meta_tables(23)
            tables.append([torch.from_numpy(t) for t in mt])
            out = tfp.fused_pairwise_step_meta(*tables, torch.from_numpy(mids),
                                               torch.from_numpy(mmask), *ids, None, 0.05,
                                               **kw, **extra)
        else:
            out = tfp.fused_pairwise_step(*tables, *ids, None, 0.05, **kw, **extra)
        runs.append((tables, out[-1], loss_out))
    (t0, l0, _), (t1, l1, slots) = runs
    assert float(l1) == float(l0) == float(slots[2])
    np.testing.assert_array_equal(slots[[0, 1, 3, 4]].numpy(), [7.0] * 4)
    for a, c in zip(t0[:2], t1[:2]):
        assert torch.equal(a, c)


def test_step_rejects_bad_inputs():
    """The step's input checks run before either path: what the kernel
    does not take raises on the CPU too."""
    user, item, _ = _tables(24)
    u, i = torch.from_numpy(user), torch.from_numpy(item)
    ids = tuple(torch.from_numpy(x) for x in _step_ids(16, 30, 25, seed=25))
    kw = dict(d=D, margin=1.0, loss_kind="hinge", sigmoid=False)
    with pytest.raises(ValueError, match="user_ids"):
        tfp.fused_pairwise_step(u, i, ids[0].int(), *ids[1:], None, **kw)
    with pytest.raises(ValueError, match="item_pk"):
        tfp.fused_pairwise_step(u, i[:, :64], *ids, None, **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        tfp.fused_pairwise_step(u, torch.cat([i, i], 1)[:, ::2], *ids, None, **kw)
    with pytest.raises(ValueError, match="d=125"):
        tfp.fused_pairwise_step(u, i, *ids, None, **dict(kw, d=125))
    with pytest.raises(ValueError, match="loss_index"):
        tfp.fused_pairwise_step(u, i, *ids, None, **kw, loss_out=torch.zeros(3), loss_index=3)
    with pytest.raises(ValueError, match="unsupported loss"):
        tfp.fused_pairwise_step(u, i, *ids, None, **dict(kw, loss_kind="warp"))
    tables, mids, mmask = _meta_tables(26)
    mv = [torch.from_numpy(t) for t in tables]
    with pytest.raises(ValueError, match="meta_mask"):
        tfp.fused_pairwise_step_meta(u, i, mv, torch.from_numpy(mids),
                                     torch.from_numpy(mmask).float(), *ids, None, **kw)
    with pytest.raises(ValueError, match="d=123"):
        tfp.fused_pairwise_step_meta(u, i, mv, torch.from_numpy(mids), torch.from_numpy(mmask),
                                     *ids, None, **dict(kw, d=123))


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("emit_g,item_upd", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, loss, sigmoid, weighted, emit_g, item_upd, bf16):
    b = 1000
    u, p, n = (torch.from_numpy(x).to(cuda_device) for x in _rows(b, seed=7, d=80))
    w = torch.rand(b, device=cuda_device) if weighted else None
    kw = dict(d=80, margin=1.0, loss_kind=loss, sigmoid=sigmoid, eps=1e-10,
              emit_g=emit_g, item_upd=item_upd, bf16=bf16)
    before = tfp.pairwise_updates_rows.launches
    got = tfp.pairwise_updates_rows(u, p, n, w, 1e-3, 0.05, **kw)
    want = tfp.pairwise_updates_rows_plain(u, p, n, w, 1e-3, 0.05, **kw)
    torch.cuda.synchronize()
    assert tfp.pairwise_updates_rows.launches == before + 1
    for g, x in zip(got, want):
        if x is None:
            assert g is None
        else:
            torch.testing.assert_close(g, x, rtol=1e-5, atol=1e-6)


def _card_step_inputs(dev, b, meta, seed):
    """Tables of 3000 users / 5000 items (D=80), ids with duplicates (a user
    on a 16th of the rows, a popular item that is also a negative, rows whose
    negative is their positive), metadata F=2 / W=3 with a fully masked item."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = 80
    user, item = (torch.zeros((n, 128), device=dev) for n in (3000, 5000))
    for t in (user, item):
        t[:, :d] = torch.randn((t.shape[0], d), generator=g, device=dev) * 0.2
        t[:, d] = torch.rand((t.shape[0],), generator=g, device=dev)
        t[:, d + 1] = torch.randn((t.shape[0],), generator=g, device=dev) * 0.1
        t[:, d + 2] = torch.rand((t.shape[0],), generator=g, device=dev)
    uid = torch.randint(0, 3000, (b,), generator=g, device=dev)
    pid, nid = (torch.randint(0, 5000, (b,), generator=g, device=dev) for _ in range(2))
    uid[: max(b // 16, 1)] = uid[0]
    pid[1::7] = pid[0]
    nid[2::11] = pid[0]
    nid[3::13] = pid[3::13]
    m = None
    if meta:
        tables = [torch.randn((rows, d + 1), generator=g, device=dev).abs_() * 0.2 for rows in (300, 20)]
        mids = torch.stack([torch.randint(0, t.shape[0], (5000, 3), generator=g, device=dev)
                            for t in tables], dim=1)
        mmask = torch.rand((5000, 2, 3), generator=g, device=dev) < 0.7
        mmask[pid[0]] = False
        m = (tables, mids, mmask)
    return user, item, (uid, pid, nid), m


# The row math's difference between the step kernel and the plain step, as a
# share of a row's updates: summation orders and IEEE 1/sqrtf against
# torch.rsqrt. bf16 takes the same share: both paths sum the metadata
# composite in the same order, so they round the same values to bf16
# (chip_smoke.py's STEP_REL).
_CARD_STEP_REL = 1e-5


def _assert_step_rows_match(name, got, want, old, ids, upd, width, rel, skip_ids):
    """Kernel table ``got`` against plain table ``want`` (both from ``old``),
    lane by lane, by chip_smoke.py's step rule: rows no id names stay bit
    for bit; on a touched row |got - want| <= 2^-24 (|got| + |want|) (each
    path rounds old + update once) + rel * (sum |update| + U), U the
    step's largest |update| in the table (a lane whose terms cancel keeps
    an fma rounding residue of terms of that size on the card, exactly 0 in
    the plain step) + k 2^-23 (|old| + sum |update|) when k >= 2 updates
    land on it (atomics add them in no fixed order) + 2^-126 (a flushed
    denormal). That stays far below one update, so a dropped or mis-scaled
    update fails. Rows in ``skip_ids``
    (at a hinge kink) are not compared."""
    uniq, inv, counts = torch.unique(ids, return_inverse=True, return_counts=True)
    untouched = torch.ones(old.shape[0], dtype=torch.bool, device=old.device)
    untouched[uniq] = False
    assert torch.equal(got[untouched], old[untouched]), f"{name}: rows no id names changed"
    f64 = torch.float64
    sums = torch.zeros((uniq.numel(), width), dtype=f64, device=old.device)
    sums.index_add_(0, inv, upd.to(f64).abs())
    g, x, o = (t[uniq, :width].to(f64) for t in (got, want, old))
    k = counts[:, None].to(f64)
    tol = (2.0**-24 * (g.abs() + x.abs()) + rel * (sums + float(upd.abs().max()))
           + torch.where(k > 1, k * 2.0**-23 * (o.abs() + sums), 0.0) + 2.0**-126)
    bad = ((g - x).abs() > tol).any(dim=1) & ~torch.isin(uniq, skip_ids)
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} rows differ by up to {float((g - x).abs()[bad].max()):.3g}")


def _kink_rows(u, p, n, sigmoid, bf16, d, width=1e-4):
    """Batch rows whose hinge diff lies within ``width`` of the kink (f64
    recompute), where the two paths may take different subgradients."""
    def rnd(x):
        return x.to(torch.bfloat16).double() if bf16 else x.double()

    raw_p = (rnd(u[:, :d]) * rnd(p[:, :d])).sum(1) + rnd(u[:, d + 1]) + rnd(p[:, d + 1])
    raw_n = (rnd(u[:, :d]) * rnd(n[:, :d])).sum(1) + rnd(u[:, d + 1]) + rnd(n[:, d + 1])
    if sigmoid:
        raw_p, raw_n = torch.sigmoid(raw_p), torch.sigmoid(raw_n)
    return (raw_n - raw_p + 1.0).abs() < width


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 33, 1000, 8192])
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sigmoid", [False, True])
@pytest.mark.parametrize("loss", ["hinge", "bpr", "logistic"])
def test_step_kernel_matches_plain_on_card(cuda_device, loss, sigmoid, weighted, bf16, meta, b):
    """The step kernel against the plain step on the card, every variant,
    each table lane by lane (``_assert_step_rows_match``: the tolerance
    is a small share of one update at every B) and the loss at rtol=1e-5,
    atol=1e-6. One kernel call counts one launch; the plain step none."""
    user, item, ids, m = _card_step_inputs(cuda_device, b, meta, seed=b)
    w = torch.rand(b, device=cuda_device) if weighted else None
    if weighted and b >= 10:  # a tenth of zero-weight filler rows
        w[-(b // 10):] = 0.0
    d = 80
    kw = dict(d=d, margin=1.0, loss_kind=loss, sigmoid=sigmoid, bf16=bf16)
    steps = ((tfp.fused_pairwise_step_meta, tfp.fused_pairwise_step_meta_plain) if meta
             else (tfp.fused_pairwise_step, tfp.fused_pairwise_step_plain))
    runs = []
    for step in steps:
        t = [user.clone(), item.clone()]
        if meta:
            t.append([x.clone() for x in m[0]])
            lead = (*t, m[1], m[2])
        else:
            lead = tuple(t)
        before = steps[0].launches
        out = step(*lead, *ids, w, 0.05, **kw)
        assert steps[0].launches - before == (1 if step is steps[0] else 0)
        runs.append((t[:2] + (t[2] if meta else []), out[-1]))
    torch.cuda.synchronize()
    (kt, kl), (pt, pl) = runs
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-6)
    # the plain step's update rows and the composite item rows, from the same tables
    uid, pid, nid = ids
    inv = tfp.step_inv(b, w)
    rk = dict(kw, eps=1e-10)
    iids = torch.cat([pid, nid])
    pn = item[iids].clone()
    if meta:
        upd_u, _, upd_i, deltas, _ = tfp._meta_step_core(user, item, m[0], m[1], m[2], *ids, w, inv,
                                                         0.05, **rk)
        for f, table in enumerate(m[0]):
            rows = table[m[1][iids][:, f, :]][..., :d]
            pn[:, :d] += (rows * m[2][iids][:, f, :, None].float()).sum(1)
    else:
        _, upd_u, upd_i, _ = tfp._pairwise_updates(user, item, *ids, w, inv, 0.05, **rk)
        deltas = []
    kink = (_kink_rows(user[uid], pn[:b], pn[b:], sigmoid, bf16, d) if loss == "hinge"
            else torch.zeros(b, dtype=torch.bool, device=cuda_device))
    kink_items = torch.cat([pid[kink], nid[kink]])
    rel = _CARD_STEP_REL
    _assert_step_rows_match("user", kt[0], pt[0], user, uid, upd_u, 128, rel, uid[kink])
    _assert_step_rows_match("item", kt[1], pt[1], item, iids, upd_i, 128, rel, kink_items)
    for f, (mid, delta) in enumerate(deltas):
        _assert_step_rows_match(f"meta{f}", kt[2 + f], pt[2 + f], m[0][f], mid, delta, d + 1, rel,
                                m[1][kink_items][:, f, :].reshape(-1))


@pytest.mark.gpu
def test_step_kernel_writes_loss_out_and_traps_bad_ids(cuda_device):
    """loss_out[i] on the card; an id out of range traps in a child process
    (a trap leaves the CUDA context unusable)."""
    import subprocess
    import sys

    user, item, ids, _ = _card_step_inputs(cuda_device, 64, False, seed=1)
    lo = torch.full((4,), 7.0, device=cuda_device)
    _, _, loss = tfp.fused_pairwise_step(user, item, *ids, None, d=80, margin=1.0,
                                         loss_kind="hinge", sigmoid=False, loss_out=lo, loss_index=1)
    torch.cuda.synchronize()
    assert float(loss) == float(lo[1]) and lo[[0, 2, 3]].tolist() == [7.0] * 3
    code = (
        "import torch; from torchrecsys_tpu_torch.ops import fused_pairwise as fp\n"
        "u = torch.zeros((10, 128), device='cuda'); i = torch.zeros((20, 128), device='cuda')\n"
        "ids = [torch.zeros(8, dtype=torch.int64, device='cuda') for _ in range(3)]; ids[0][5] = 10\n"
        "fp.fused_pairwise_step(u, i, *ids, None, d=80, margin=1.0, loss_kind='hinge', sigmoid=False)\n"
        "torch.cuda.synchronize()\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode != 0

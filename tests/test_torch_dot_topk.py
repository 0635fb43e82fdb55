"""The port's fused score + top-k (torchrecsys_tpu_torch/ops/dot_topk.py)
against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and passed to both packages as numpy
arrays. Two kinds of input:

- exact-arithmetic: small integers, so every dot product and bias sum is
  exact in f32 whatever the summation order. Scores tie often; ids must
  match exactly, tie order included.
- random normals: values must match within rtol=1e-5, atol=1e-6 (f32 sums
  in another order), and ids must match except where two reference scores
  in a row lie within that tolerance of each other.

The CUDA kernels themselves run only on a card: the ``gpu`` tests at the
end hold them against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrecsys_tpu.ops import dot_topk as jdt
from torchrecsys_tpu_torch.ops import dot_topk as tdt

RTOL, ATOL = 1e-5, 1e-6


def _exact(u, n, d, seed=0):
    r = np.random.default_rng(seed)
    return (
        r.integers(-3, 4, (u, d)).astype(np.float32),
        r.integers(-3, 4, (n, d)).astype(np.float32),
        r.integers(-3, 4, (n,)).astype(np.float32),
    )


def _normal(u, n, d, seed=0):
    r = np.random.default_rng(seed)
    return (
        r.normal(size=(u, d)).astype(np.float32),
        r.normal(size=(n, d)).astype(np.float32),
        r.normal(size=(n,)).astype(np.float32),
    )


def _seen(u, n, seed=0, most=None):
    """Per-user seen lists; with ``most`` the first user has seen all but
    ``most`` items (fewer unseen than k)."""
    r = np.random.default_rng(seed)
    seen = [np.unique(r.integers(0, n, r.integers(0, n // 3))) for _ in range(u)]
    if most is not None:
        seen[0] = np.sort(r.choice(n, n - most, replace=False))
    return seen


def _port(fn, uv, iv, ib, k, mask=None, **kw):
    v, i = fn(
        torch.from_numpy(uv), torch.from_numpy(iv), torch.from_numpy(ib), k,
        seen_mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    return v.numpy(), i.numpy()


def _jax(fn, uv, iv, ib, k, mask=None, **kw):
    v, i = fn(
        jnp.asarray(uv), jnp.asarray(iv), jnp.asarray(ib), k,
        seen_mask=None if mask is None else jnp.asarray(mask), **kw,
    )
    return np.asarray(v), np.asarray(i)


def _assert_close_topk(v, i, rv, ri):
    """Values within RTOL/ATOL; an id may differ only where the reference
    row has another score within that tolerance next to it."""
    np.testing.assert_allclose(v, rv, rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(rv)
    for r, p in zip(*np.nonzero(i != ri)):
        near = [q for q in (p - 1, p + 1) if 0 <= q < rv.shape[1]]
        assert any(abs(rv[r, q] - rv[r, p]) <= tol[r, p] for q in near), (r, p)


# ---------------------------------------------------------------------------
# K1's function (k <= 16) against _dot_topk_kernel (dot_topk_pallas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "u,n,d,k",
    [(1, 100, 16, 10), (7, 700, 24, 16), (33, 1500, 8, 5), (4, 9, 4, 16)],
)
def test_small_exact_ids_match_pallas(u, n, d, k):
    uv, iv, ib = _exact(u, n, d, seed=u + n)
    rv, ri = _jax(jdt.dot_topk_pallas, uv, iv, ib, k, interpret=True, n_tile=256)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, k)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)


@pytest.mark.parametrize("u,n,d,k", [(5, 1000, 24, 10), (40, 3000, 16, 16)])
def test_small_random_matches_pallas(u, n, d, k):
    uv, iv, ib = _normal(u, n, d, seed=n)
    rv, ri = _jax(jdt.dot_topk_pallas, uv, iv, ib, k, interpret=True)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, k)
    _assert_close_topk(v, i, rv, ri)


def test_small_bf16_matches_pallas():
    """bf16 vectors: products are exact in f32, sums run in f32; exact
    integers keep ids exact, random values stay within tolerance."""
    import ml_dtypes

    for make, exact in ((_exact, True), (_normal, False)):
        uv, iv, ib = make(6, 700, 24, seed=3)
        uvb, ivb = uv.astype(ml_dtypes.bfloat16), iv.astype(ml_dtypes.bfloat16)
        rv, ri = _jax(jdt.dot_topk_pallas, uvb, ivb, ib, 8, interpret=True, n_tile=256)
        v, i = tdt.dot_topk_small(
            torch.from_numpy(uvb.astype(np.float32)).bfloat16(),
            torch.from_numpy(ivb.astype(np.float32)).bfloat16(),
            torch.from_numpy(ib), 8,
        )
        assert v.dtype == torch.float32 and i.dtype == torch.int32
        if exact:
            np.testing.assert_array_equal(i.numpy(), ri)
            np.testing.assert_array_equal(v.numpy(), rv)
        else:
            _assert_close_topk(v.numpy(), i.numpy(), rv, ri)


def test_small_tie_order_matches_pallas():
    """Bit-equal scores rank by lowest item id across and within tiles
    (the case of tests/test_ops.py::test_dot_topk_tie_order_matches_xla)."""
    n, k = 1024, 6
    vals = np.linspace(-50, -10, n).astype(np.float32)
    vals[7], vals[900] = 9.0, 8.0
    vals[256 + 17] = vals[768 + 30] = 5.0
    vals[512 + 3] = vals[512 + 200] = 4.0
    uv = np.ones((3, 1), np.float32)
    iv = vals[:, None].copy()
    ib = np.zeros(n, np.float32)
    rv, ri = _jax(jdt.dot_topk_pallas, uv, iv, ib, k, interpret=True, n_tile=256, u_tile=8)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, k)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)
    assert list(i[0][2:]) == [256 + 17, 768 + 30, 512 + 3, 512 + 200]


def test_k_exceeds_catalog_and_padding_never_wins():
    uv, iv, ib = _normal(2, 20, 8)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, 50)
    assert v.shape == (2, 20) and sorted(i[0].tolist()) == list(range(20))
    # three items, all hugely negative: no padded row may appear
    uv, iv, ib = np.ones((1, 4), np.float32), -100 * np.ones((3, 4), np.float32), np.zeros(3, np.float32)
    rv, ri = _jax(jdt.dot_topk_pallas, uv, iv, ib, 3, interpret=True)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, 3)
    np.testing.assert_array_equal(i, ri)
    assert set(i[0].tolist()) == {0, 1, 2}


# ---------------------------------------------------------------------------
# K2's function (16 < k <= 1024) against _dot_topk_threshold_kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [20, 70, 130])
def test_large_exact_matches_thresh(k):
    """Exact integers, heavy ties. Against lax.top_k (dot_topk_xla) ids match
    exactly. Against the threshold kernel values match exactly, and ids too
    on every row where no tie straddles the k-th value (there the TPU kernel
    documents a loose tie rule, ops/dot_topk.py:388-393)."""
    uv, iv, ib = _exact(9, 500, 12, seed=k)
    xv, xi = _jax(jdt.dot_topk_xla, uv, iv, ib, k)
    tv, ti = _jax(jdt.dot_topk_pallas_thresh, uv, iv, ib, k, interpret=True, n_tile=256)
    v, i = _port(tdt.dot_topk_large, uv, iv, ib, k)
    np.testing.assert_array_equal(i, xi)
    np.testing.assert_array_equal(v, tv)
    full = uv @ iv.T + ib[None, :]
    for r in range(uv.shape[0]):
        kth = np.sort(full[r])[::-1][k - 1]
        if (full[r] == kth).sum() == (v[r] == kth).sum():
            np.testing.assert_array_equal(i[r], ti[r])


@pytest.mark.parametrize("k", [20, 130])
def test_large_random_matches_thresh(k):
    uv, iv, ib = _normal(9, 500, 12, seed=k)
    rv, ri = _jax(jdt.dot_topk_pallas_thresh, uv, iv, ib, k, interpret=True, n_tile=256)
    v, i = _port(tdt.dot_topk_large, uv, iv, ib, k)
    _assert_close_topk(v, i, rv, ri)


@pytest.mark.parametrize("d", [136, 160, 192, 300])
def test_rows_wider_than_128_lanes_match_pallas(d):
    """D above 128 (136: the card's slab path ends in a tail of 8 f32
    lanes; NeuCF's 2 x 80 item table; 192: no tail; 300: a width the JAX
    kernels pad to 384): exact integers give #1's ids and values exactly,
    random normals stay within tolerance of #1 and #2."""
    uv, iv, ib = _exact(9, 600, d, seed=d)
    rv, ri = _jax(jdt.dot_topk_pallas, uv, iv, ib, 10, interpret=True, n_tile=256)
    v, i = _port(tdt.dot_topk_small, uv, iv, ib, 10)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)
    uv, iv, ib = _normal(9, 600, d, seed=d + 1)
    for jfn, tfn, k in ((jdt.dot_topk_pallas, tdt.dot_topk_small, 16),
                        (jdt.dot_topk_pallas_thresh, tdt.dot_topk_large, 40)):
        rv, ri = _jax(jfn, uv, iv, ib, k, interpret=True, n_tile=256)
        v, i = _port(tfn, uv, iv, ib, k)
        _assert_close_topk(v, i, rv, ri)


def test_large_k_exceeds_catalog_and_padding():
    uv, iv, ib = _normal(3, 90, 12)
    rv, ri = _jax(jdt.dot_topk_pallas_thresh, uv, iv, ib, 200, interpret=True, n_tile=256)
    v, i = _port(tdt.dot_topk_large, uv, iv, ib, 200)
    assert v.shape == (3, 90) and (i < 90).all()
    _assert_close_topk(v, i, rv, ri)


# ---------------------------------------------------------------------------
# Packed seen masks
# ---------------------------------------------------------------------------


def test_pack_seen_mask_bit_exact_and_decode():
    n = 9000
    seen = _seen(7, n, seed=1)
    seen.append(np.zeros(0, np.int64))
    seen[0] = np.union1d(seen[0], [31 * 128, 4096 + 31 * 128 + 5])  # bit 31
    m = tdt.pack_seen_mask(seen, n)
    np.testing.assert_array_equal(m, jdt.pack_seen_mask(seen, n))
    assert m.dtype == np.int32 and m.shape == (8, 12288 // 32)
    pos = np.repeat(np.arange(len(seen)), [len(s) for s in seen])
    mt = tdt.pack_seen_mask_torch(
        torch.from_numpy(pos), torch.from_numpy(np.concatenate(seen)), len(seen), n
    )
    np.testing.assert_array_equal(mt.numpy(), m)
    ids = np.arange(n, dtype=np.int32)
    bits = tdt.mask_bits_for_items(torch.from_numpy(m), torch.from_numpy(ids).long())
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jdt.mask_bits_for_items(jnp.asarray(m), jnp.asarray(ids)))
    )


@pytest.mark.parametrize("kernel", ["small", "large"])
def test_masked_exact_matches_pallas(kernel):
    """Masked items score float32-min and keep their index, so a user with
    fewer unseen items than k gets the masked tail in index order, as
    lax.top_k (dot_topk_xla) gives it. The first user here has 5 unseen
    items; past those the Pallas kernels return their scratch's initial
    ids instead (0 for the unrolled kernel), which predict overwrites
    (api.py:_patch_short_unseen_rows), so there only the values are held."""
    n, k = 300, (12 if kernel == "small" else 40)
    uv, iv, ib = _exact(6, n, 8, seed=5)
    seen = _seen(6, n, seed=5, most=5)
    mask = tdt.pack_seen_mask(seen, n)
    fn, jfn = {
        "small": (tdt.dot_topk_small, jdt.dot_topk_pallas),
        "large": (tdt.dot_topk_large, jdt.dot_topk_pallas_thresh),
    }[kernel]
    rv, ri = _jax(jfn, uv, iv, ib, k, mask, interpret=True)
    xv, xi = _jax(jdt.dot_topk_xla, uv, iv, ib, k, mask)
    v, i = _port(fn, uv, iv, ib, k, mask)
    np.testing.assert_array_equal(i, xi)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(i[0, :5], ri[0, :5])
    if kernel == "small":  # the threshold kernel's tie rule is loose
        np.testing.assert_array_equal(i[1:], ri[1:])
    assert (v[0, 5:] == tdt._NEG_INF).all()
    np.testing.assert_array_equal(i[0, 5:], np.sort(i[0, 5:]))
    for r, s in enumerate(seen[1:], start=1):
        assert not set(i[r].tolist()) & set(s.tolist())


def test_wrappers_take_only_cpu_or_cuda_tensors():
    """A CPU tensor takes the plain version; any other non-CUDA device is
    refused rather than silently computed elsewhere."""
    meta = [torch.empty(s, device="meta") for s in ((2, 4), (50, 4), (50,))]
    for fn in (tdt.dot_topk_small, tdt.dot_topk_large):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(*meta, 3)


# ---------------------------------------------------------------------------
# Dispatch and the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 16, 17, 1024, 1025])
def test_dispatch_equals_plain_and_xla(k):
    uv, iv, ib = _exact(5, 1200, 6, seed=k)
    v, i = _port(tdt.dot_topk, uv, iv, ib, k)
    pv, pi = _port(tdt.dot_topk_plain, uv, iv, ib, k, chunk=97)
    xv, xi = _jax(jdt.dot_topk_xla, uv, iv, ib, k)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(i, xi)
    np.testing.assert_array_equal(v, xv)


def test_approx_recall_is_exact():
    uv, iv, ib = _normal(4, 300, 8, seed=2)
    v, i = _port(tdt.dot_topk, uv, iv, ib, 10)
    av, ai = _port(tdt.dot_topk, uv, iv, ib, 10, approx_recall=0.9)
    np.testing.assert_array_equal(ai, i)
    np.testing.assert_array_equal(av, v)


# ---------------------------------------------------------------------------
# The kernel's 3xTF32 scores, emulated
# ---------------------------------------------------------------------------

CARD_ATOL, CARD_RTOL = 1e-4, 1e-5  # chip_smoke.py's tolerance for random inputs


def _tf32(x):
    """x with its low 13 mantissa bits cleared: the TF32 value the tensor
    cores read from an f32 operand."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_scores(uv, iv, ib, terms):
    """users . items^T + bias from TF32 parts, as the kernel computes f32
    scores: x = big + small with big = tf32(x) and small = tf32(x - big)
    for both operands; the products of the parts are exact here (f64), the
    sum rounds to f32 as the kernel's accumulators do, and the bias is added
    in f32. ``terms`` names the products kept beside big.big: "item_small"
    (item small . user big), "user_small" (item big . user small)."""
    ub, ibg = _tf32(uv), _tf32(iv)
    us, isml = _tf32(uv - ub), _tf32(iv - ibg)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    acc = f(ub) @ f(ibg).T
    if "item_small" in terms:
        acc += f(ub) @ f(isml).T
    if "user_small" in terms:
        acc += f(us) @ f(ibg).T
    return acc.astype(np.float32) + ib[None, :]


def _within_card_tolerance(uv, iv, ib, got):
    truth = uv.astype(np.float64) @ iv.astype(np.float64).T + ib.astype(np.float64)[None, :]
    return bool((np.abs(got.astype(np.float64) - truth) <= CARD_ATOL + CARD_RTOL * np.abs(truth)).all())


@pytest.mark.parametrize("d", [13, 80, 128])
def test_3xtf32_scores_meet_the_card_tolerance(d):
    """big.big + big.small + small.big (the kernel's f32 scores) land within
    chip_smoke.py's atol = 1e-4 + rtol = 1e-5 of an f64 truth on randn
    inputs, at the main path's D = 80, a D that is not a multiple of 4, and
    the widest D."""
    uv, iv, ib = _normal(64, 4096, d, seed=d)
    assert _within_card_tolerance(uv, iv, ib, _split_scores(uv, iv, ib, ("item_small", "user_small")))


@pytest.mark.parametrize("terms", [("user_small",), ("item_small",), ()],
                         ids=["no_item_small", "no_user_small", "1xtf32"])
@pytest.mark.parametrize("d", [13, 80, 128])
def test_fewer_tf32_terms_miss_the_card_tolerance(d, terms):
    """The same check catches a dropped remainder: with the items' small
    part left out, the users', or both (plain TF32), scores leave the
    tolerance, so all three products are needed."""
    uv, iv, ib = _normal(64, 4096, d, seed=d)
    assert not _within_card_tolerance(uv, iv, ib, _split_scores(uv, iv, ib, terms))


# ---------------------------------------------------------------------------
# On the card: each kernel against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 16, 17, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize(
    "u,n,d",
    [(40, 20000, 80), (1, 20000, 80), (257, 20000, 80), (40, 1_000_003, 80), (40, 20000, 13), (40, 20000, 84),
     (40, 20000, 128), (40, 20000, 136), (40, 20000, 160), (40, 20000, 192), (40, 20000, 256), (40, 20000, 300),
     (257, 20000, 300), (40, 20000, 1000)],
    ids=["main", "U1", "U257", "N1000003", "D13", "D84", "D128", "D136", "D160", "D192", "D256", "D300",
         "D300U257", "D1000"],
)
def test_kernel_matches_plain_on_card(cuda_device, k, dtype, masked, u, n, d):
    """Exact inputs: ids and values equal to the plain version's, at the
    main width and at edge shapes (a partial user tile, a partial item tile
    and split, rows that are not whole 16-byte units, the widest one-unit
    row), and on the slab path: a tail unit of 8 f32 lanes (136), of 32
    (160), none (192, 256), half-size user tiles (300, also with a partial
    user tile) and the 8-user tile of one warpgroup (1000 f32, k <= 16); a
    repeated call gives the same bits."""
    uv, iv, ib = (torch.from_numpy(a).to(cuda_device) for a in _exact(u, n, d, seed=k))
    uv, iv = uv.to(dtype), iv.to(dtype)
    mask = None
    if masked:
        mask = torch.from_numpy(tdt.pack_seen_mask(_seen(u, n, most=3), n)).to(cuda_device)
    fn = tdt.dot_topk_small if k <= 16 else tdt.dot_topk_large
    before = fn.launches
    v, i = fn(uv, iv, ib, k, seen_mask=mask)
    v2, i2 = fn(uv, iv, ib, k, seen_mask=mask)
    pv, pi = tdt.dot_topk_plain(uv, iv, ib, k, seen_mask=mask)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(i, pi) and torch.equal(v, pv)
    assert torch.equal(i2, i) and torch.equal(v2, v)


# The widest D that the plan took with 128-lane slabs (before the slab
# path's TMA boxes), per list length k (each k a buffer size of its own):
# (k, f32, bf16). chip_smoke.py's TOPK_REACH holds the same grid.
_PLAN_REACH = ((1, 2432, 11776), (16, 2432, 11776), (17, 2432, 11776), (64, 2432, 11776), (128, 2304, 11264),
               (129, 2304, 11264), (192, 2304, 11264), (193, 2048, 10240), (448, 2048, 10240),
               (449, 1536, 8192), (960, 1536, 8192), (961, 512, 4096), (1024, 512, 4096))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_keeps_its_reach_on_card(cuda_device, bf16):
    """Every (D, k, dtype) of _PLAN_REACH plans (every D up to the old
    widest, a multiple of 4 for f32, 8 for bf16), and a row past the reach
    raises from the plan: no fallback. A call planned before the grid
    launches again after it: planning smaller shapes of the same kernel
    variant leaves its shared memory opt-in where the cached plan needs it."""
    step, past = (8, 32768) if bf16 else (4, 8192)
    dtype = torch.bfloat16 if bf16 else torch.float32
    uv, iv, ib = (torch.from_numpy(a).to(cuda_device) for a in _exact(256, 20000, 80, seed=3))
    uv, iv = uv.to(dtype), iv.to(dtype)
    v0, i0 = tdt.dot_topk_large(uv, iv, ib, 128)
    for k, *reach in _PLAN_REACH:
        for d in range(step, reach[bf16] + 1, step):
            tdt.plan(k > 16, 256, 20000, d, bf16, k)
        with pytest.raises(ValueError, match="no kernel variant"):
            tdt.plan(k > 16, 256, 20000, past, bf16, k)
    v1, i1 = tdt.dot_topk_large(uv, iv, ib, 128)
    torch.cuda.synchronize()
    assert torch.equal(i1, i0) and torch.equal(v1, v0)

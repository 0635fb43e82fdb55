"""HSTU's pointwise attention (torchrecsys_tpu_torch/ops/hstu_attention.py,
kernel pair #9 in ops/csrc/hstu_attention.cu). Nothing here imports JAX:
``python -m pytest --noconftest -m gpu -s tests/test_torch_hstu_attention.py``
runs the card's tests where JAX is not.

On the CPU: the kernels' backward algorithm written in plain torch (S
recomputed, dS = dA * SiLU'(S) / L * M, dw the sums of dS along the
diagonals) against autograd of ``pointwise_attention_plain`` in float64;
the skipping rule (no unmasked pair is skipped, and chip_smoke.py's count
of it, ``tile_pairs``, matches the kernels' loops); the wrappers' checks
(at any window and head width); the CPU entry is the plain version.

On the card: the kernels against float64 at the HSTU cell's widths (512
histories, L = 200, 2 heads of 25, q, k, v strided views of one (B, L, 4d)
projection as the model passes them), each output and gradient within
max(1e-6, 2 x the plain f32 version's own gap); the same at L = 50 (with
the weights of a 200-long window) and at shapes the staged kernels do not
take (heads wider than 32, windows past 256: the streamed kernels); bf16
inputs against the plain f32 version; two backward runs bit for bit, on
both plans.
"""

import pytest
import torch

import chip_smoke
from torchrecsys_tpu_torch.models import hstu
from torchrecsys_tpu_torch.ops import hstu_attention as ha

import plain_hstu as ph  # tests/ is on sys.path under pytest; another installed "tests" package may shadow ours

MASKS = ["left_aligned", "interleaved", "empty", "full", "single"]


def _mask(kind: str, b: int, length: int, gen: torch.Generator, device="cpu") -> torch.Tensor:
    """(B, L) masks: windows from position 0 of random lengths (0 and L
    included), holes (the last position too), none, all, one position."""
    pos = torch.arange(length, device=device)
    if kind == "left_aligned":
        n = torch.randint(0, length + 1, (b,), generator=gen, device=device)
        n[0], n[-1] = 0, length
        return pos[None] < n[:, None]
    if kind == "interleaved":
        return torch.rand((b, length), generator=gen, device=device) > 0.4
    if kind == "empty":
        return torch.zeros((b, length), dtype=torch.bool, device=device)
    if kind == "full":
        return torch.ones((b, length), dtype=torch.bool, device=device)
    one = torch.randint(0, length, (b,), generator=gen, device=device)
    return pos[None] == one[:, None]


def _inputs(b, length, heads, dh, history_len, dtype, gen, device="cpu", scale=0.45):
    """q, k, v as strided views of one (B, L, 4 h dh) projection (u, v, q, k,
    as the model splits it), w of a ``history_len`` window and dO, each
    N(0, scale^2) (q . k of order one at dh = 25, so every SiLU bends)."""
    width = heads * dh
    uvqk = torch.randn((b, length, 4 * width), generator=gen, device=device, dtype=dtype) * scale
    _, v, q, k = torch.split(uvqk, width, dim=-1)
    w = torch.randn((2 * history_len - 1,), generator=gen, device=device, dtype=dtype) * scale
    dout = torch.randn((b, length, width), generator=gen, device=device, dtype=dtype)
    return q, k, v, w, dout


def _plain_grads(q, k, v, w, valid, heads, dout):
    """o and (dq, dk, dv, dw) of pointwise_attention_plain by autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, w)]
    o = ha.pointwise_attention_plain(*leaves[:3], leaves[3], valid, heads)
    return o.detach(), torch.autograd.grad(o, leaves, dout)


def _kernel_rule(q, k, v, w, valid, heads, dout):
    """The kernels' algorithm in plain torch: o, and the backward that
    recomputes S from q, k and w, forms dS = dA * (1/L) * SiLU'(S) * M and
    takes dw as the sum of dS along each diagonal (only j <= i: w[L..] gets
    0)."""
    b, length, width = q.shape
    dh = width // heads

    def split(t):
        return t.reshape(b, length, heads, dh).transpose(1, 2)

    i = torch.arange(length)
    m = ((i[None, :] <= i[:, None])[None] & valid[:, None, :])[:, None]  # (B, 1, L, L)
    idx = (i[None, :] - i[:, None] + length - 1).clamp(0, length - 1)
    z = split(q) @ split(k).transpose(-1, -2) + w[idx]
    sg = torch.sigmoid(z)
    inv_l = 1.0 / length
    a = torch.where(m, z * sg * inv_l, 0.0)
    o = (a @ split(v)).transpose(1, 2).reshape(b, length, width)
    do = split(dout)
    da = do @ split(v).transpose(-1, -2)
    ds = torch.where(m, da * inv_l * (sg * (1 + z * (1 - sg))), 0.0)
    dv = a.transpose(-1, -2) @ do
    dq = ds @ split(k)
    dk = ds.transpose(-1, -2) @ split(q)
    per_pair = ds.sum(dim=(0, 1))
    dw = torch.zeros_like(w)
    for d in range(length):  # diagonal j - i = d - (L - 1)
        dw[d] = torch.diagonal(per_pair, offset=d - (length - 1)).sum()

    def merge(t):
        return t.transpose(1, 2).reshape(b, length, width)

    return o, (merge(dq), merge(dk), merge(dv), dw)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("length", [1, 7, 50, 200])
@pytest.mark.parametrize("kind", MASKS)
def test_the_kernels_backward_rule_is_autograd_of_the_plain_version(kind, length, heads):
    gen = torch.Generator().manual_seed(length * 10 + heads)
    valid = _mask(kind, 3, length, gen)
    q, k, v, w, dout = _inputs(3, length, heads, 5, length, torch.float64, gen)
    o, grads = _kernel_rule(q, k, v, w, valid, heads, dout)
    want_o, want = _plain_grads(q, k, v, w, valid, heads, dout)
    torch.testing.assert_close(o, want_o, rtol=1e-12, atol=1e-14)
    for name, got, ref in zip(("dq", "dk", "dv", "dw"), grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14, msg=name)
    if kind == "empty":
        assert not o.any() and not any(g.any() for g in grads)


@pytest.mark.parametrize("kind", ["left_aligned", "interleaved"])
def test_a_window_shorter_than_the_weights_moves_only_its_own(kind):
    """L = 50 against w of a 200-long window: R takes w[:99], so only those
    weights get a gradient (and of them only w[:50], the diagonals j <= i)."""
    gen = torch.Generator().manual_seed(5)
    valid = _mask(kind, 4, 50, gen)
    q, k, v, w, dout = _inputs(4, 50, 2, 5, 200, torch.float64, gen)
    _, grads = _kernel_rule(q, k, v, w, valid, 2, dout)
    _, want = _plain_grads(q, k, v, w, valid, 2, dout)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-14)
    assert want[3][:50].any() and not want[3][50:].any()


def _pairs_by_loop(valid: torch.Tensor) -> dict:
    """The kernels' loops over (tile, block) pairs, as the source writes
    them, and every pair each loop covers."""
    bsz, length = valid.shape
    nb = -(-length // 16)
    counts = {"fwd": 0, "bwd_dkdv": 0}
    cover = {"fwd": torch.zeros((bsz, length, length), dtype=torch.bool),
             "bwd_dkdv": torch.zeros((bsz, length, length), dtype=torch.bool)}
    for b in range(bsz):
        vb = torch.zeros(nb * 16, dtype=torch.bool)
        vb[:length] = valid[b]
        blocks = [bool(vb[16 * c: 16 * c + 16].any()) for c in range(nb)]
        for t in range(nb):
            i0 = 16 * t
            for c in range(min(i0 + 15, length - 1) // 16 + 1):
                if blocks[c]:
                    counts["fwd"] += 1
                    cover["fwd"][b, i0: i0 + 16, 16 * c: 16 * c + 16] = True
        for kt in range(nb):
            if blocks[kt]:
                for c in range(kt, (length - 1) // 16 + 1):
                    counts["bwd_dkdv"] += 1
                    cover["bwd_dkdv"][b, 16 * c: 16 * c + 16, 16 * kt: 16 * kt + 16] = True
    return counts, cover


@pytest.mark.parametrize("length", [1, 7, 50, 200, 256])
def test_skipping_leaves_no_unmasked_pair_out(length):
    gen = torch.Generator().manual_seed(length)
    valid = torch.cat([_mask(kind, 4, length, gen) for kind in MASKS])
    counts, cover = _pairs_by_loop(valid)
    got = chip_smoke.tile_pairs(torch, valid)
    square = valid.shape[0] * (-(-length // 16)) ** 2
    assert got == {"fwd": (counts["fwd"], square), "bwd_dq": (counts["fwd"], square),
                   "bwd_dkdv": (counts["bwd_dkdv"], square)}
    i = torch.arange(length)
    unmasked = (i[None, :] <= i[:, None])[None] & valid[:, None, :]
    for rule in cover.values():
        assert not (unmasked & ~rule).any()
    if length == 200:  # the cell's windows: about half the square is left
        cell = torch.arange(length)[None] < torch.tensor([[131]])
        fwd, square = chip_smoke.tile_pairs(torch, cell)["fwd"]
        assert 0.40 < fwd / square < 0.55, fwd / square


def _wrapper_calls(q, k, v, w, valid, dout, heads=2):
    return [lambda: ha.hstu_attention_fwd(q, k, v, w, valid, heads),
            lambda: ha.hstu_attention_bwd(q, k, v, w, valid, dout, heads)]


def _base(dtype=torch.float32, length=12):
    gen = torch.Generator().manual_seed(0)
    q, k, v, w, dout = _inputs(3, length, 2, 4, length, dtype, gen)
    return q, k, v, w, _mask("interleaved", 3, length, gen), dout


BAD = {
    "float64": (TypeError, "float32 or bfloat16", lambda q, k, v, w, m, d: (q.double(), k.double(), v.double(),
                                                                          w.double(), m, d.double())),
    "mixed_types": (TypeError, "q's", lambda q, k, v, w, m, d: (q, k.bfloat16(), v, w, m, d)),
    "weights_of_another_type": (TypeError, "q's", lambda q, k, v, w, m, d: (q, k, v, w.bfloat16(), m, d)),
    "two_dims": (ValueError, "heads", lambda q, k, v, w, m, d: (q[0], k[0], v[0], w, m, d)),
    "shape_beside_q": (ValueError, "beside q", lambda q, k, v, w, m, d: (q, k[:, :-1], v, w, m, d)),
    "width_not_split_by_heads": (ValueError, "heads", lambda q, k, v, w, m, d: (q[..., :7], k[..., :7], v[..., :7],
                                                                                  w, m, d[..., :7])),
    "short_weights": (ValueError, "2L - 1", lambda q, k, v, w, m, d: (q, k, v, w[:-1], m, d)),
    "mask_not_bool": (ValueError, "bool", lambda q, k, v, w, m, d: (q, k, v, w, m.float(), d)),
    "mask_shape": (ValueError, "bool", lambda q, k, v, w, m, d: (q, k, v, w, m[:, :-1], d)),
    "last_stride": (ValueError, "stride", lambda q, k, v, w, m, d: (q, k.mT.contiguous().mT, v, w, m, d)),
    "weights_strided": (ValueError, "stride", lambda q, k, v, w, m, d: (q, k, v, torch.stack([w, w], 1)[:, 0], m, d)),
    "mask_not_contiguous": (ValueError, "contiguous", lambda q, k, v, w, m, d: (q, k, v, w,
                                                                                 torch.stack([m, m], 2)[..., 0], d)),
    "other_device": (ValueError, "different devices", lambda q, k, v, w, m, d: (q, k, v.to("meta"), w, m, d)),
    "cpu": (ValueError, "CUDA tensors", lambda q, k, v, w, m, d: (q, k, v, w, m, d)),
}


@pytest.mark.parametrize("part", ["fwd", "bwd"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_wrappers_refuse_what_the_kernels_do_not_take(case, part):
    err, match, alter = BAD[case]
    args = alter(*_base())
    calls = dict(zip(("fwd", "bwd"), _wrapper_calls(*args)))
    before = (ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches)
    with pytest.raises(err, match=match):
        calls[part]()
    assert (ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches) == before


@pytest.mark.parametrize("shape", [(3, 257, 2, 4), (3, 12, 1, 33), (2, 20, 1, 80)],
                         ids=["L_past_256", "dh_past_32", "facade_default_width"])
def test_wrappers_take_any_window_and_head_width(shape):
    """Past the staged kernels' 256 x 32 the shape checks pass (the
    streamed kernels take it); on the CPU the only refusal left is the
    device's."""
    b, length, heads, dh = shape
    gen = torch.Generator().manual_seed(1)
    q, k, v, w, dout = _inputs(b, length, heads, dh, length, torch.float32, gen)
    valid = _mask("full", b, length, gen)
    for call in _wrapper_calls(q, k, v, w, valid, dout, heads):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_cpu_entry_is_the_plain_version(dtype, monkeypatch):
    gen = torch.Generator().manual_seed(2)
    q, k, v, w, dout = _inputs(4, 20, 2, 5, 24, dtype, gen)
    valid = _mask("interleaved", 4, 20, gen)
    before = (ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches)
    want_o, want = _plain_grads(q, k, v, w, valid, 2, dout)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, w)]
    o = ha.pointwise_attention(*leaves, valid, 2)
    got = torch.autograd.grad(o, leaves, dout)
    assert torch.equal(o.detach(), want_o) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches) == before
    # R is models/hstu.py's relative_bias, looked up at call time
    monkeypatch.setattr(hstu, "relative_bias", lambda w_, n: torch.zeros((n, n), dtype=w_.dtype))
    assert not torch.equal(ha.pointwise_attention(q, k, v, w, valid, 2), want_o)


def test_the_launch_counters_are_registered():
    from torchrecsys_tpu_torch.utils import profiling

    names = {"hstu_attention.fwd_launches", "hstu_attention.bwd_launches"}
    assert names <= set(profiling.COUNTERS) and names <= set(profiling.counters())


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel pair #9 runs only there")
    return torch.device("cuda")


def _card_masks(b, length, gen, device):
    """The cell's windows (from position 0, ~131 of 200 valid: lengths 0.45 L
    to L) with the positive's hole, beside interleaved, empty, full and
    single-position rows."""
    kinds = MASKS + ["cell"]
    per = -(-b // len(kinds))
    rows = []
    for kind in kinds:
        if kind == "cell":
            n = length - (0.55 * length * torch.rand((per,), generator=gen, device=device)).long()
            m = torch.arange(length, device=device)[None] < n[:, None]
            m &= torch.rand((per, length), generator=gen, device=device) > 0.01
        else:
            m = _mask(kind, per, length, gen, device)
        rows.append(m)
    return torch.cat(rows)[:b].contiguous()


def _gap(got, want):
    """||got - want|| / ||want|| in float64 (0 over 0 reads 0)."""
    den = float(want.norm())
    return float((got.double() - want.double()).norm()) / (den if den > 0 else 1.0)


def _card_case(device, length, history_len, seed=7, b=512):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, w, dout = _inputs(b, length, 2, 25, history_len, torch.float32, gen, device)
    valid = _card_masks(b, length, gen, device)
    return q, k, v, w, valid, dout


@pytest.mark.gpu
@pytest.mark.parametrize("length,history_len", [(200, 200), (50, 200)], ids=["L200", "L50_of_200"])
def test_kernels_match_float64_on_card(cuda_device, length, history_len):
    q, k, v, w, valid, dout = _card_case(cuda_device, length, history_len)
    f0, b0 = ha.hstu_attention_fwd.launches, ha.hstu_attention_bwd.launches
    o = ha.hstu_attention_fwd(q, k, v, w, valid, 2)
    grads = ha.hstu_attention_bwd(q, k, v, w, valid, dout, 2)
    torch.cuda.synchronize()
    assert (ha.hstu_attention_fwd.launches - f0, ha.hstu_attention_bwd.launches - b0) == (1, 1)
    with ph.ieee_f32():
        o32, plain = _plain_grads(q, k, v, w, valid, 2, dout)
        o64, ref = _plain_grads(*(t.double() for t in (q, k, v, w)), valid, 2, dout.double())
    gaps = {"o": (_gap(o, o64), _gap(o32, o64))}
    gaps.update({n: (_gap(g, r), _gap(p, r)) for n, g, p, r in zip(("dq", "dk", "dv", "dw"), grads, plain, ref)})
    for n, (gk, gp) in gaps.items():
        print(f"[hstu_attention] L={length}: {n} kernel {gk:.3e}, plain f32 {gp:.3e}")
    bad = {n: v_ for n, v_ in gaps.items() if v_[0] > max(1e-6, 2 * v_[1])}
    assert not bad, bad
    assert not grads[3][length:].any()  # only the diagonals j <= i get a gradient
    empty = ~valid.any(dim=1)
    assert not o[empty].any() and not grads[0][empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,length,heads,dh", [
    (3, 1, 1, 4), (5, 7, 3, 8), (64, 33, 2, 32), (16, 256, 1, 25),
    (64, 20, 1, 80), (32, 200, 1, 80), (16, 300, 2, 25), (8, 257, 1, 33), (6, 520, 3, 40), (5, 3, 1, 1),
    (8, 40, 1, 160),
], ids=["L1", "L7_h3_dh8", "L33_dh32", "L256", "L20_dh80", "L200_dh80", "L300", "L257_dh33", "L520_h3_dh40",
        "L3_dh1", "L40_dh160"])
def test_kernels_match_float64_at_other_shapes_on_card(cuda_device, b, length, heads, dh):
    """Fewer problems than blocks, one row, odd widths, the widest head and
    the longest window the staged kernels take, and past them (the streamed
    kernels): RecSys's default head (1 of 80) at its default window (20)
    and at 200, windows past 256, three heads of 40, a head of 160 (two
    groups of 128 columns); every mask kind."""
    gen = torch.Generator(device=cuda_device).manual_seed(length)
    q, k, v, w, dout = _inputs(b, length, heads, dh, length + 3, torch.float32, gen, cuda_device)
    valid = torch.stack([_mask(kind, b, length, gen, cuda_device) for kind in MASKS], 1).reshape(-1, length)[:b]
    valid = valid.contiguous()  # the kinds in turn, row by row
    o = ha.hstu_attention_fwd(q, k, v, w, valid, heads)
    grads = ha.hstu_attention_bwd(q, k, v, w, valid, dout, heads)
    with ph.ieee_f32():
        o32, plain = _plain_grads(q, k, v, w, valid, heads, dout)
        o64, ref = _plain_grads(*(t.double() for t in (q, k, v, w)), valid, heads, dout.double())
    gaps = {"o": (_gap(o, o64), _gap(o32, o64))}
    gaps.update({n: (_gap(g, r), _gap(p, r)) for n, g, p, r in zip(("dq", "dk", "dv", "dw"), grads, plain, ref)})
    bad = {n: v_ for n, v_ in gaps.items() if v_[0] > max(1e-6, 2 * v_[1])}
    assert not bad, bad
    assert not grads[3][length:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("length", [200, 50])
def test_bf16_kernels_track_plain_f32_on_card(cuda_device, length):
    """bf16 in and out, f32 inside: each output and gradient within 2^-7 of
    the plain f32 version on the same (bf16) inputs, relative in norm; the
    outputs' own bf16 rounding is up to 2^-9 an element."""
    q, k, v, w, valid, dout = _card_case(cuda_device, length, 200, seed=8)
    q, k, v, w, dout = (t.bfloat16() for t in (q, k, v, w, dout))
    o = ha.hstu_attention_fwd(q, k, v, w, valid, 2)
    grads = ha.hstu_attention_bwd(q, k, v, w, valid, dout, 2)
    assert o.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    with ph.ieee_f32():
        o32, plain = _plain_grads(*(t.float() for t in (q, k, v, w)), valid, 2, dout.float())
    gaps = {"o": _gap(o, o32)}
    gaps.update({n: _gap(g, p) for n, g, p in zip(("dq", "dk", "dv", "dw"), grads, plain)})
    print(f"[hstu_attention] bf16 L={length}: " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
    assert all(g <= 2 ** -7 for g in gaps.values()), gaps


@pytest.mark.gpu
def test_two_backward_runs_give_the_same_bits(cuda_device):
    q, k, v, w, valid, dout = _card_case(cuda_device, 200, 200, seed=9)
    first = ha.hstu_attention_bwd(q, k, v, w, valid, dout, 2)
    second = ha.hstu_attention_bwd(q, k, v, w, valid, dout, 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(ha.hstu_attention_fwd(q, k, v, w, valid, 2), ha.hstu_attention_fwd(q, k, v, w, valid, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("length,heads,dh", [(200, 1, 80), (300, 2, 25)], ids=["L200_dh80", "L300"])
def test_streamed_kernels_in_bf16_and_their_repeats_on_card(cuda_device, length, heads, dh):
    """The streamed kernels: bf16 inputs within 2^-7 of the plain f32
    version on the same inputs (as the staged kernels' bf16 test), and two
    forward and two backward runs bit for bit in f32."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v, w, dout = _inputs(64, length, heads, dh, length, torch.float32, gen, cuda_device)
    valid = _card_masks(64, length, gen, cuda_device)
    first = ha.hstu_attention_bwd(q, k, v, w, valid, dout, heads)
    second = ha.hstu_attention_bwd(q, k, v, w, valid, dout, heads)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(ha.hstu_attention_fwd(q, k, v, w, valid, heads),
                       ha.hstu_attention_fwd(q, k, v, w, valid, heads))
    q, k, v, w, dout = (t.bfloat16() for t in (q, k, v, w, dout))
    o = ha.hstu_attention_fwd(q, k, v, w, valid, heads)
    grads = ha.hstu_attention_bwd(q, k, v, w, valid, dout, heads)
    assert o.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    with ph.ieee_f32():
        o32, plain = _plain_grads(*(t.float() for t in (q, k, v, w)), valid, heads, dout.float())
    gaps = {"o": _gap(o, o32)}
    gaps.update({n: _gap(g, p) for n, g, p in zip(("dq", "dk", "dv", "dw"), grads, plain)})
    print(f"[hstu_attention] streamed bf16 L={length} dh={dh}: " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
    assert all(g <= 2 ** -7 for g in gaps.values()), gaps

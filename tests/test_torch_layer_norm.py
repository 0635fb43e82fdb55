"""The sequence encoder's layer norm (torchrecsys_tpu_torch/ops/layer_norm.py,
ops/csrc/layer_norm.cu).

- On the CPU, :func:`layer_norm` is :func:`layer_norm_plain` bit for bit,
  forward and gradients, padded (all-zero) rows included;
  :func:`layer_norm_plain` is SASRec's formula, and in f32 lies within
  1e-5 of float64 (the yardstick the card's tests hold the kernels to);
  the wrappers refuse a wrong type, a mixed type, a wrong last dim, a
  strided input and CPU tensors.
- On the card (``gpu``): the kernels against float64 and the plain version
  in f32 and bf16 at the SASRec cell's shape (409,600 x 50, 30% zero rows)
  and at d in {1, 7, 50, 64, 128, 300, 1024}; the backward's sums repeat
  bit for bit; one SASRec encoder step at the cell's widths with every
  dense leaf's gradient norm held to a float64 step at 1e-6 (the cell's
  check, tenfold tighter), five launches of each kernel.
  This file imports no JAX: ``python -m pytest --noconftest -m gpu -s
  tests/test_torch_layer_norm.py`` runs it where a card is and JAX is not.
"""

import numpy as np
import pytest
import torch

from torchrecsys_tpu_torch.config import ModelConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model, sasrec
from torchrecsys_tpu_torch.ops import layer_norm as ln

EPS = 1e-6
GRAD_FLOOR = 1e-6  # the encoder gate and the kernels' floor: a tenth of the cell's grad_gap limit


def _inputs(rows, d, dtype, zero_share=0.3, seed=0, device="cpu"):
    """x (rows, d) at the encoder's scale (unit spread after the residuals),
    a ``zero_share`` of its rows zero (padding) with a zero cotangent there,
    scale ~ 1 + N(0, 0.1^2), bias ~ N(0, 0.1^2), dy ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g) + 0.3 * torch.randn(rows, 1, generator=g)
    zero = torch.rand(rows, generator=g) < zero_share
    x[zero] = 0.0
    dy = torch.randn(rows, d, generator=g)
    dy[zero] = 0.0
    scale = 1.0 + 0.1 * torch.randn(d, generator=g)
    bias = 0.1 * torch.randn(d, generator=g)
    return [t.to(dtype).to(device) for t in (x, dy, scale, bias)] + [zero.to(device)]


def _autograd(fn, x, dy, scale, bias):
    """``fn(x, scale, bias)`` and its gradients for the cotangent dy."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    y = fn(*leaves)
    return (y.detach(),) + torch.autograd.grad(y, leaves, dy)


def _old_formula(x, scale, bias):
    """SASRec's layer norm as the encoder wrote it before the kernel."""
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.mean(torch.square(x - m), dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + EPS) * scale + bias


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_on_cpu_is_the_plain_version_bit_for_bit(dtype):
    x, dy, scale, bias, _ = _inputs(6 * 7, 9, dtype)
    x, dy = x.view(6, 7, 9), dy.view(6, 7, 9)
    f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
    got = _autograd(lambda *a: ln.layer_norm(*a, EPS), x, dy, scale, bias)
    want = _autograd(lambda *a: ln.layer_norm_plain(*a, EPS), x, dy, scale, bias)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_layer_norm_plain_is_the_encoders_formula(dtype):
    """Bit for bit the formula SASRec's encoder ran before the kernel, and
    ``models.sasrec._layer_norm`` is it at the encoder's eps."""
    x, _, scale, bias, _ = _inputs(40, 50, dtype, seed=1)
    want = _old_formula(x, scale, bias)
    assert torch.equal(ln.layer_norm_plain(x, scale, bias, EPS), want)
    assert torch.equal(sasrec._layer_norm(x, scale, bias), want)
    assert sasrec._LN_EPS == EPS


@pytest.mark.parametrize("d", [1, 7, 50, 64, 130])
def test_plain_f32_is_near_float64(d):
    """The yardstick: layer_norm_plain in f32 against itself in float64,
    y and dx within 1e-5 of the largest reference entry, dscale and dbias
    within 1e-5 of the sum of their terms' magnitudes; padded rows give
    y == bias and dx == 0 exactly, and nothing is NaN or Inf."""
    x, dy, scale, bias, zero = _inputs(500, d, torch.float32, seed=d)
    got = _autograd(lambda *a: ln.layer_norm_plain(*a, EPS), x, dy, scale, bias)
    ref = _autograd(lambda *a: ln.layer_norm_plain(*a, EPS), *(t.double() for t in (x, dy, scale, bias)))
    y, dx, dscale, dbias = got
    for g, want in ((y, ref[0]), (dx, ref[1])):
        assert float((g.double() - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1.0)
    xd = x.double()
    xhat = (xd - xd.mean(-1, keepdim=True)) * torch.rsqrt(xd.var(-1, unbiased=False, keepdim=True) + EPS)
    for g, want, terms in ((dscale, ref[2], dy.double() * xhat), (dbias, ref[3], dy.double())):
        assert torch.all((g.double() - want).abs() <= 1e-5 * terms.abs().sum(0) + 1e-12)
    assert torch.equal(y[zero], bias.expand(int(zero.sum()), d)) and not dx[zero].any()
    assert all(torch.isfinite(t).all() for t in got)


def _stats(x):
    """A row's f32 mean and rstd, as the forward kernel keeps them."""
    mean = x.float().mean(-1)
    return mean, torch.rsqrt(torch.square(x.float() - mean[:, None]).mean(-1) + EPS)


def _bad(case):
    """(error, message fragment, call) for a refused input."""
    x, dy, scale, bias, _ = _inputs(12, 6, torch.float32)
    stats = _stats(x)
    if case == "f64_x":
        return TypeError, "float32 or bfloat16", lambda: ln.layer_norm_fwd(x.double(), scale.double(),
                                                                         bias.double(), EPS)
    if case == "mixed_scale":
        return TypeError, "every input", lambda: ln.layer_norm_fwd(x, scale.bfloat16(), bias, EPS)
    if case == "mixed_dy":
        return TypeError, "every input", lambda: ln.layer_norm_bwd(x, dy.bfloat16(), scale, *stats)
    if case == "last_dim":
        return ValueError, "expected", lambda: ln.layer_norm_fwd(x, torch.ones(7), torch.zeros(7), EPS)
    if case == "dy_shape":
        return ValueError, "expected", lambda: ln.layer_norm_bwd(x, dy[:, :5].contiguous(), scale, *stats)
    if case == "strided":
        return ValueError, "contiguous", lambda: ln.layer_norm_fwd(x.t().contiguous().t(), scale, bias, EPS)
    if case == "stats_dtype":
        return ValueError, "mean and rstd", lambda: ln.layer_norm_bwd(x, dy, scale, *(s.double() for s in stats))
    if case == "cpu_fwd":
        return ValueError, "CUDA tensors", lambda: ln.layer_norm_fwd(x, scale, bias, EPS)
    if case == "cpu_bwd":
        return ValueError, "CUDA tensors", lambda: ln.layer_norm_bwd(x, dy, scale, *stats)
    return ValueError, "rows, d", lambda: ln.layer_norm_fwd(x.view(3, 4, 6), scale, bias, EPS)  # "not_2d"


@pytest.mark.parametrize("case", ["f64_x", "mixed_scale", "mixed_dy", "last_dim", "dy_shape", "strided",
                                  "stats_dtype", "not_2d", "cpu_fwd", "cpu_bwd"])
def test_wrappers_refuse_bad_inputs(case):
    err, match, call = _bad(case)
    f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
    with pytest.raises(err, match=match):
        call()
    assert (ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches) == (f0, b0)


# ---------------------------------------------------------------------------
# on the card (needs a CUDA card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64 (0 where both are 0)."""
    den = float(want.norm())
    num = float((got.double() - want).norm())
    return num / den if den > 0 else num


KERNEL_CASES = [(409_600, 50)] + [(3_000, d) for d in (1, 7, 50, 64, 128, 300, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", KERNEL_CASES)
def test_kernels_match_float64_on_card(cuda_device, rows, d, dtype):
    """y, dx, dscale and dbias each within twice the plain version's own
    relative gap to float64 (same type, same inputs), or within 1e-6 where
    that is larger; padded rows give y == bias and dx == 0 exactly; no NaN
    or Inf; one launch each."""
    x, dy, scale, bias, zero = _inputs(rows, d, dtype, seed=rows + d, device=cuda_device)
    f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
    y, mean, rstd = ln.layer_norm_fwd(x, scale, bias, EPS)
    dx, dscale, dbias = ln.layer_norm_bwd(x, dy, scale, mean, rstd)
    torch.cuda.synchronize()
    assert (ln.layer_norm_fwd.launches - f0, ln.layer_norm_bwd.launches - b0) == (1, 1)
    plain = _autograd(lambda *a: ln.layer_norm_plain(*a, EPS), x, dy, scale, bias)
    ref = _autograd(lambda *a: ln.layer_norm_plain(*a, EPS), *(t.double() for t in (x, dy, scale, bias)))
    lines = []
    for name, got, p, r in zip(("y", "dx", "dscale", "dbias"), (y, dx, dscale, dbias), plain, ref):
        assert got.dtype == dtype and torch.isfinite(got.float()).all(), name
        k_gap, p_gap = _gap(got, r), _gap(p, r)
        lines.append(f"{name} {k_gap:.3e} (plain {p_gap:.3e})")
        assert k_gap <= max(2 * p_gap, GRAD_FLOOR), f"{name}: kernel {k_gap:.3e}, plain {p_gap:.3e}"
    print(f"[layer_norm] {rows} x {d} {dtype}: gap to float64 " + ", ".join(lines))
    assert torch.equal(y[zero], bias.expand(int(zero.sum()), d)) and not dx[zero].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(409_600, 50), (3_000, 1024)])
def test_kernels_repeat_bit_for_bit_on_card(cuda_device, rows, d, dtype):
    """Two runs of each kernel give the same bits: no atomics in dscale and
    dbias, whose partials are added in a fixed order."""
    x, dy, scale, bias, _ = _inputs(rows, d, dtype, seed=7, device=cuda_device)
    first = ln.layer_norm_fwd(x, scale, bias, EPS)
    again = ln.layer_norm_fwd(x, scale, bias, EPS)
    back = [ln.layer_norm_bwd(x, dy, scale, *first[1:]) for _ in range(2)]
    for a, b in list(zip(first, again)) + list(zip(*back)):
        assert torch.equal(a, b)


def _leaves(tree, prefix=""):
    """Dotted paths of the tensors of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: t for k in sorted(tree) for p, t in _leaves(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {p: t for i, v in enumerate(tree) for p, t in _leaves(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _rebuild(tree, flat, prefix=""):
    """``tree``'s structure with the tensors of ``flat`` (by dotted path)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, f"{prefix}{k}.") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def _leaf_gaps(got, ref):
    """Each leaf's gap between two gradient norms, over the larger of the
    leaf's reference norm and the median leaf's (as the SASRec cell's
    ``grad_gap`` reads it)."""
    med = float(np.median(list(ref.values())))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def _encoder_grad_norms(model, dense, emb, mask, q, dtype):
    """One encoder step in ``dtype``: the user vectors of (B, L, d) history
    rows, a logistic loss on their score against one item vector each, and
    the norm of every dense leaf's gradient, the packed q, k, v projections
    as three leaves, as the cell's check takes them (and of the history
    rows')."""
    model.compute_dtype = dtype
    flat = {k: t.detach().to(dtype).requires_grad_() for k, t in _leaves(dense).items()}
    hist = emb.detach().to(dtype).requires_grad_()
    h = model._encode(_rebuild(dense, flat), hist, mask)
    loss = torch.nn.functional.softplus(-(h * q.to(dtype)).sum(-1)).mean()
    grads = torch.autograd.grad(loss, [hist] + list(flat.values()))
    norms = {"hist": float(grads[0].norm())}
    for path, grad in zip(flat, grads[1:]):
        if path.endswith(("qkv.w", "qkv.b")):
            for name, part in zip("qkv", torch.chunk(grad, 3, dim=-1)):
                norms[f"{path}:{name}"] = float(part.norm())
        else:
            norms[path] = float(grad.norm())
    return norms


@pytest.mark.gpu
def test_encoder_step_gradients_match_float64_on_card(cuda_device, monkeypatch):
    """The SASRec cell's widths (B=8192, L=50, d=50, 2 blocks, 1 head), ~30%
    of positions padded, holes in the histories, 64 empty ones: every
    dense leaf's gradient norm (and the history rows') within 1e-6 of a
    float64 step through the plain norm, by the cell's rule (over the
    larger of the leaf's norm and the median leaf's), or within twice the plain f32 norm's own gap
    where that is larger. The kernel step launches each kernel 2 x blocks
    + 1 = 5 times."""
    b, length, d = 8192, 50, 50
    store = prepare_data({"user_id": np.arange(100) % 10, "item_id": np.arange(100)}, "user_id", "item_id")
    model = build_model(store.schema, ModelConfig(net_type="sasrec", n_factors=d, history_len=length,
                                                  sasrec_blocks=2, sasrec_heads=1))
    g = torch.Generator(device=cuda_device).manual_seed(11)
    dense = model.init_dense(g)
    for path, p in _leaves(dense).items():  # the norms' scale and bias off 1 and 0, as a trained model's
        if ".ln" in f".{path}":
            p.add_(0.1 * torch.randn(p.shape, generator=g, device=cuda_device))
    emb = torch.randn((b, length, d), generator=g, device=cuda_device) / d
    lengths = length - (0.55 * length * torch.rand((b,), generator=g, device=cuda_device)).long()
    lengths[:64] = 0
    mask = torch.arange(length, device=cuda_device)[None] < lengths[:, None]
    mask &= torch.rand((b, length), generator=g, device=cuda_device) > 0.02
    q = torch.randn((b, d), generator=g, device=cuda_device) / d

    f0, b0 = ln.layer_norm_fwd.launches, ln.layer_norm_bwd.launches
    kernel = _encoder_grad_norms(model, dense, emb, mask, q, torch.float32)
    torch.cuda.synchronize()
    launches = (ln.layer_norm_fwd.launches - f0, ln.layer_norm_bwd.launches - b0)
    monkeypatch.setattr(sasrec, "layer_norm", ln.layer_norm_plain)
    plain = _encoder_grad_norms(model, dense, emb, mask, q, torch.float32)
    ref = _encoder_grad_norms(model, dense, emb, mask, q, torch.float64)
    assert launches == (5, 5)
    k_gaps = _leaf_gaps(kernel, ref)
    p_gaps = _leaf_gaps(plain, ref)
    for k in ref:
        print(f"[layer_norm] encoder leaf {k}: kernel {k_gaps[k]:.3e}, plain f32 {p_gaps[k]:.3e}")
    print(f"[layer_norm] encoder median leaf: kernel {np.median(list(k_gaps.values())):.3e}, plain f32 "
          f"{np.median(list(p_gaps.values())):.3e}; worst: kernel {max(k_gaps.values()):.3e}, plain f32 "
          f"{max(p_gaps.values()):.3e}")
    bad = {k: (k_gaps[k], p_gaps[k]) for k in ref if k_gaps[k] > max(GRAD_FLOOR, 2 * p_gaps[k])}
    assert not bad, f"leaves off float64 beyond max(1e-6, 2 x plain f32): {bad}"

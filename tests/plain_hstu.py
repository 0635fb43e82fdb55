"""Plain reference of HSTU (Zhai et al., ICML 2024, arXiv:2402.17152) for
the tests: the encoder, the scorer and logistic steps with rowwise
adagrad on the item rows and adam on the dense tree. Plain torch in the
dtype of its inputs; it imports no JAX and nothing of the JAX package or
of the port, and it writes the equations out as the paper states them,
not as the port arranges them (R by an index gather, the mask by one
``torch.where``, the norms by their formula, no recompute).

With x (B, L, d), h heads, dqk = dv = d / h: x = (sqrt(d) e + p) * valid;
each block z = LN(x) (no affine, eps 1e-6), [u, v, q, k] = SiLU(z
W_uvqk), a = SiLU(q k^T + R) / L * M with R[i, j] = w[j - i + L - 1] and
M[b, i, j] = [j <= i] and valid[b, j], y = (LN(concat_h(a v)) * u) W_o +
b_o, x = (x + y) * valid; the user vector is the state at the last valid
position over max(|h|, 1e-6). A training row (u, i+, i-) hides i+ from
u's history, encodes it once and scores ``s = <h, q_i> + b_i`` for both
items; its loss is ``-(log sigmoid(s+) + log sigmoid(-s-)) / 2``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
NORM_EPS = 1e-6
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """Matrix products in IEEE float32 on the card: TF32 off for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    m = x.mean(dim=-1, keepdim=True)
    var = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(var + LN_EPS)


def relative_bias(w: torch.Tensor, length: int) -> torch.Tensor:
    """(L, L) R[i, j] = w[j - i + L - 1]."""
    i = torch.arange(length, device=w.device)
    return w[i[None, :] - i[:, None] + length - 1]


def encode(dense, hist: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, d) history rows and (B, L) mask -> (B, d) user vectors."""
    b, length, d = hist.shape
    dh = d // heads
    keep = mask[..., None].to(hist.dtype)
    x = (hist * d ** 0.5 + dense["pos"][:length][None]) * keep
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=hist.device))
    allowed = (causal[None] & mask[:, None, :])[:, None]  # (B, 1, L, L)
    for blk in dense["blocks"]:
        u, v, q, k = torch.split(F.silu(layer_norm(x) @ blk["uvqk"]["w"]), d, dim=-1)
        q, k, v = (t.reshape(b, length, heads, dh).transpose(1, 2) for t in (q, k, v))
        s = q @ k.transpose(-1, -2) + relative_bias(blk["rab_pos"], length)
        a = torch.where(allowed, F.silu(s) / length, torch.zeros_like(s))
        o = (a @ v).transpose(1, 2).reshape(b, length, d)
        x = (x + (layer_norm(o) * u) @ blk["o"]["w"] + blk["o"]["b"]) * keep
    last = torch.where(mask, torch.arange(length, device=hist.device)[None], -1).max(dim=1).values
    h = x[torch.arange(b, device=hist.device), last.clamp_min(0)]
    h = torch.where((last >= 0)[:, None], h, torch.zeros_like(h))
    return h / h.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)


def score(dense, item: torch.Tensor, item_bias: torch.Tensor, hist: torch.Tensor, mask: torch.Tensor,
          heads: int) -> torch.Tensor:
    """``<h, q_i> + b_i`` for (B, d) item rows and (B, 1) biases."""
    return (encode(dense, hist, mask, heads) * item).sum(dim=-1) + item_bias[:, 0]


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted paths of the tensors of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: t for k in sorted(tree) for p, t in flatten(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {p: t for i, v in enumerate(tree) for p, t in flatten(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree``'s structure with the tensors of ``flat`` (by dotted path)."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], flat, f"{prefix}{k}.") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, sites, lr: float, eps: float = 1e-10) -> None:
    """In place, over every gathered occurrence ``(ids, g)`` of a step: each
    occurrence moves its row by ``-lr g / sqrt(acc_before + mean(g^2) +
    eps)`` and adds ``mean(g^2)`` to the row's accumulator."""
    d = table.shape[1]
    ids = torch.cat([i.reshape(-1) for i, _ in sites])
    g = torch.cat([x.reshape(-1, d) for _, x in sites])
    msq = (g * g).mean(dim=1)
    scale = torch.rsqrt(acc[ids] + msq + eps)
    table.index_add_(0, ids, -lr * g * scale[:, None])
    acc.index_add_(0, ids, msq)


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict, lr: float) -> None:
    """One adam step on flat ``params`` in place (optax's update)."""
    t = state["t"] = state.get("t", 0) + 1
    c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
    for k, p in params.items():
        g = grads[k]
        m = state["m"][k] = ADAM_B1 * state["m"].get(k, torch.zeros_like(p)) + (1 - ADAM_B1) * g
        v = state["v"][k] = ADAM_B2 * state["v"].get(k, torch.zeros_like(p)) + (1 - ADAM_B2) * g * g
        p -= lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)


def logistic_steps(tables: Dict[str, torch.Tensor], dense, batches: List[Dict[str, torch.Tensor]], lr: float,
                   hist_ids: torch.Tensor, hist_mask: torch.Tensor, heads: int) -> Dict:
    """Logistic steps from copies of ``tables`` (``item`` (R, d),
    ``item_bias`` (R, 1)) and ``dense`` over ``batches`` (dicts of
    ``user``, ``pos``, ``neg``; the mean over the rows), with the users'
    (U, L) history windows. Returns each step's loss, the first step's
    gradients (the tables' as rowwise adagrad's accumulators after it, the
    dense leaves by path), and the tables, accumulators and dense leaves
    after the last step."""
    t = {k: v.clone() for k, v in tables.items()}
    acc = {k: torch.zeros(v.shape[0], dtype=v.dtype, device=v.device) for k, v in t.items()}
    params = {k: v.clone() for k, v in flatten(dense).items()}
    opt: Dict = {"m": {}, "v": {}}
    losses, first = [], {}
    for step, bt in enumerate(batches):
        u, pos, neg = bt["user"], bt["pos"], bt["neg"]
        b = u.shape[0]
        hist = hist_ids[u]
        mask = hist_mask[u] & (hist != pos[:, None])
        items = torch.cat([pos, neg])
        q = t["item"][items].requires_grad_()
        qb = t["item_bias"][items].requires_grad_()
        hr = t["item"][hist].requires_grad_()
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        h = encode(rebuild(dense, leaves), hr, mask, heads)
        s = (h.repeat(2, 1) * q).sum(dim=-1) + qb[:, 0]
        loss = (-0.5 * (F.logsigmoid(s[:b]) + F.logsigmoid(-s[b:]))).mean()
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [q, qb, hr] + [leaves[k] for k in keys])
        g_dense = dict(zip(keys, grads[3:]))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            rowwise_adagrad(t["item"], acc["item"], [(items, grads[0]), (hist, grads[2])], lr)
            rowwise_adagrad(t["item_bias"], acc["item_bias"], [(items, grads[1])], lr)
            adam(params, g_dense, opt, lr)
        if step == 0:
            first = {"acc": {k: a.clone() for k, a in acc.items()}, "dense": g_dense}
    return {"losses": losses, "first": first, "tables": t, "acc": acc, "dense": params}

"""Plain reference of HSTU (Zhai et al., ICML 2024, arXiv:2402.17152) as
the configuration states it, trained with the pointwise logistic loss
against one sampled negative.

A user's history is their last L train interactions, in the train split's
order, left-aligned, padded after (reference/sasrec.py's windows). Its
encoding, with h heads and dqk = dv = d / h: x = (sqrt(d) e + p) * valid
(e the item rows, p the learned positions); per block z = LN(x) (no
affine parameters, eps 1e-6), [u, v, q, k] = SiLU(z W_uvqk), per head a =
SiLU(q k^T + R) / L * M with R[i, j] = w[j - i + L - 1] (the block's 2L -
1 position weights, shared by the heads) and M[b, i, j] = [j <= i] and
valid[b, j], y = (LN(concat_h(a v)) * u) W_o + b_o, x = (x + y) * valid;
the user vector is the state at the last valid position over max(|h|,
1e-6) (zeros for an empty history). A training row (u, i+, i-) hides i+
from u's history, encodes it once and scores ``s = <h, q_i> + b_i`` for
both items; its loss is ``-(log sigmoid(s+) + log sigmoid(-s-)) / 2``.
Departures from the paper, as in the program: no time-bucket bias rab^t,
no dropout, an item bias and no item L2 norm or temperature, one training
row per interaction. Item rows take rowwise adagrad per gathered
occurrence (history occurrences included), dense parameters adam, at one
learning rate.

A step's rows go through the encoder :data:`CHUNK` at a time, each
chunk's share of the loss differentiated alone and the gradients added:
the whole batch's (B, h, L, L) products would not fit on the card beside
themselves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.plain import adam, flatten, ieee_f32, mm, rowwise_adagrad
from perfbench.reference.sasrec import _rebuild, histories, make_tables  # noqa: F401  (the same tables)

LN_EPS = 1e-6
NORM_EPS = 1e-6
CHUNK = 1024  # training rows through the encoder at once


def make_dense(port: Dict, gen: torch.Generator):
    """Seeded dense parameters in the program's layout: per block
    ``uvqk`` ``{"w"}`` (d, 4d) ~ N(0, 1/d) (so that z W_uvqk is of order
    one and every SiLU bends; the published N(0, 0.02^2) keeps them in
    their linear part), ``o`` ``{"w" (d, d) ~ U(-1/sqrt(d), 1/sqrt(d)),
    "b" ~ N(0, 0.1^2)}``, ``rab_pos`` (2L - 1,) ~ N(0, 0.5^2); ``pos`` (L,
    d) ~ N(0, 1/d^2). ``port``: ``n_factors`` (d), ``history_len`` (L),
    ``hstu_blocks``."""
    d, length, blocks = int(port["n_factors"]), int(port["history_len"]), int(port["hstu_blocks"])
    dev = gen.device
    bound = d ** -0.5

    def block():
        return {
            "uvqk": {"w": torch.randn((d, 4 * d), generator=gen, device=dev) * bound},
            "o": {"w": torch.rand((d, d), generator=gen, device=dev) * (2 * bound) - bound,
                  "b": torch.randn((d,), generator=gen, device=dev) * 0.1},
            "rab_pos": torch.randn((2 * length - 1,), generator=gen, device=dev) * 0.5,
        }

    out = {"blocks": [block() for _ in range(blocks)]}
    out["pos"] = torch.randn((length, d), generator=gen, device=dev) / d
    return out


def clone_dense(dense):
    return _rebuild(dense, {k: v.clone() for k, v in flatten(dense).items()})


def aux(train_users: np.ndarray, train_items: np.ndarray, n_users: int, n_items: int, port: Dict, device) -> Dict:
    """What a step needs besides the weights: every user's history window
    and the number of heads."""
    idx, mask = histories(train_users, train_items, n_users, int(port["history_len"]))
    return {"hist": torch.as_tensor(idx, device=device), "hist_mask": torch.as_tensor(mask, device=device),
            "heads": int(port["hstu_heads"])}


def dense_views(dense) -> Dict[str, torch.Tensor]:
    """Each dense parameter by its path; the packed u, v, q, k projection
    as four parameters (``...uvqk.w:u`` etc.), since each is one
    mathematically."""
    out = {}
    for path, t in flatten(dense).items():
        if path.endswith("uvqk.w"):
            for name, part in zip("uvqk", torch.chunk(t, 4, dim=-1)):
                out[f"{path}:{name}"] = part
        else:
            out[path] = t
    return out


def _ln(x):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + LN_EPS)


def encode(dense, hist: torch.Tensor, mask: torch.Tensor, heads: int, low: bool) -> torch.Tensor:
    """(B, L, d) history rows, (B, L) mask -> (B, d) user vectors; matrix
    products in TF32 for the control (``low``)."""
    b, length, d = hist.shape
    dh = d // heads
    keep = mask[..., None].float()
    x = (hist * d ** 0.5 + dense["pos"][:length][None]) * keep
    i = torch.arange(length, device=hist.device)
    offset = i[None, :] - i[:, None] + length - 1
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=hist.device))
    allowed = (causal[None] & mask[:, None, :])[:, None]  # (B, 1, L, L)
    for blk in dense["blocks"]:
        u, v, q, k = torch.split(F.silu(mm(_ln(x), blk["uvqk"]["w"], low)), d, dim=-1)
        q, k, v = (t.reshape(b, length, heads, dh).transpose(1, 2) for t in (q, k, v))
        s = mm(q, k.transpose(-1, -2), low) + blk["rab_pos"][offset]
        a = torch.where(allowed, F.silu(s) / length, torch.zeros_like(s))
        o = mm(a, v, low).transpose(1, 2).reshape(b, length, d)
        x = (x + mm(_ln(o) * u, blk["o"]["w"], low) + blk["o"]["b"]) * keep
    last = torch.where(mask, i[None], -1).max(dim=1).values
    h = x[torch.arange(b, device=hist.device), last.clamp_min(0)]
    h = torch.where((last >= 0)[:, None], h, torch.zeros_like(h))
    return h / h.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)


def train_steps(tables: Dict[str, torch.Tensor], dense, batches, lr: float, aux: Dict,
                low: bool = False, half: bool = False) -> Dict:
    """Logistic steps from ``tables`` and ``dense`` (copied) over
    ``batches`` (dicts of ``user``, ``pos``, ``neg``, ``w``,
    ``weight_sum``); ``aux`` as :func:`aux` gives it. ``low`` and ``half``
    as in mf.py: the products in TF32, the loss over the first half of the
    batch. Returns each step's loss, the first step's gradient norms
    (tables over their gathered occurrences, dense parameters by
    :func:`dense_views`) and every parameter's change after the last
    step."""
    t = {k: v.clone() for k, v in tables.items()}
    acc = {k: torch.zeros(v.shape[0], dtype=torch.float32, device=v.device) for k, v in t.items()}
    params = {k: v.clone() for k, v in flatten(dense).items()}
    opt: Dict = {"m": {}, "v": {}}
    losses, grad_norms = [], {}
    for step, bt in enumerate(batches):
        u, pos, neg, w = bt["user"], bt["pos"], bt["neg"], bt["w"]
        b = u.shape[0]
        if half:
            coef = torch.zeros(b, device=u.device)
            coef[: b // 2] = 1.0 / (b // 2)
        else:
            coef = w / max(float(bt["weight_sum"]), 1.0)
        hist = aux["hist"][u]
        mask = aux["hist_mask"][u] & (hist != pos[:, None])
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        keys = list(leaves)
        tree = _rebuild(dense, leaves)
        item_sites, bias_sites = [], []  # (ids, gradient) of every gathered occurrence
        g_dense = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = torch.zeros((), device=u.device)
        for lo in range(0, b, CHUNK):
            rows = slice(lo, min(b, lo + CHUNK))
            pair = torch.cat([pos[rows], neg[rows]])
            q = t["item"][pair].requires_grad_()
            qb = t["item_bias"][pair].requires_grad_()
            hr = t["item"][hist[rows]].requires_grad_()
            with ieee_f32():
                h = encode(tree, hr, mask[rows], aux["heads"], low)
                s = (h.repeat(2, 1) * q).sum(dim=-1) + qb[:, 0]
            n = h.shape[0]
            per_row = -0.5 * (F.logsigmoid(s[:n]) + F.logsigmoid(-s[n:]))
            part = torch.sum(per_row * coef[rows])
            grads = torch.autograd.grad(part, [q, qb, hr] + [leaves[k] for k in keys])
            item_sites += [(pair, grads[0]), (hist[rows], grads[2])]
            bias_sites.append((pair, grads[1]))
            for k, g in zip(keys, grads[3:]):
                g_dense[k] += g
            loss += part.detach()
        losses.append(float(loss))
        if step == 0:
            grad_norms = {name: float(torch.sqrt(sum((g ** 2).sum() for _, g in sites)))
                          for name, sites in (("item", item_sites), ("item_bias", bias_sites))}
            grad_norms.update({k: float(v.norm()) for k, v in dense_views(_rebuild(dense, g_dense)).items()})
        with torch.no_grad():
            rowwise_adagrad(t["item"], acc["item"], item_sites, lr)
            rowwise_adagrad(t["item_bias"], acc["item_bias"], bias_sites, lr)
            adam(params, g_dense, opt, lr)
    change = {k: float((t[k] - tables[k]).norm()) for k in tables}
    before, after = dense_views(dense), dense_views(_rebuild(dense, params))
    change.update({k: float((after[k] - before[k]).norm()) for k in before})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

"""Plain reference of SASRec (Kang & McAuley, ICDM 2018, arXiv:1808.09781)
as the configuration states it, trained with the pointwise logistic loss
against one sampled negative.

A user's history is their last L train interactions, in the train split's
order, left-aligned, padded after. Its encoding: the item embeddings plus
learned positions, zeroed at padding; ``blocks`` pre-norm blocks of causal
self-attention over valid keys (an additive -1e9 mask) with an output
projection, and a relu feed-forward of width d, each added back, padding
zeroed after each block; a last layer norm (eps 1e-6); the user vector is
the state at the last valid position (zeros for an empty history). A
training row (u, i+, i-) hides i+ from u's history, encodes it once and
scores ``s = <h, q_i> + b_i`` for both items; its loss is
``-(log sigmoid(s+) + log sigmoid(-s-)) / 2``. Departures from the paper,
as in the program: no dropout, an item bias, one training row per
interaction rather than one per position, a bias on every projection, and
layer norm before (not after) each sublayer on queries, keys and values
alike. Item rows take rowwise adagrad per gathered occurrence (history
occurrences included), dense parameters adam, at one learning rate.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.plain import adam, flatten, ieee_f32, mm, rowwise_adagrad

TABLES = ("item", "item_bias")
LN_EPS = 1e-6


def make_tables(shapes: Dict[str, Tuple[int, int]], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    if set(shapes) != set(TABLES):
        raise ValueError(f"tables {sorted(shapes)} are not SASRec's {sorted(TABLES)}")
    out = {}
    for name in TABLES:
        rows, dim = shapes[name]
        std = 0.1 if dim == 1 else 1.0 / dim
        out[name] = torch.randn((rows, dim), generator=gen, device=gen.device) * std
    return out


def make_dense(port: Dict, gen: torch.Generator):
    """Seeded dense parameters in the layout the configuration names:
    per block ``qkv`` (d, 3d), ``attn_out``, ``ffn1``, ``ffn2`` (d, d), each
    ``{"w", "b"}`` ~ U(-1/sqrt(d), 1/sqrt(d)), ``ln1``/``ln2`` ``{"scale",
    "bias"}`` ~ 1 + N(0, 0.1^2) / N(0, 0.1^2); ``ln_out``; ``pos`` (L, d) ~
    N(0, 1/d^2). ``port``: ``n_factors`` (d), ``history_len`` (L),
    ``sasrec_blocks``."""
    d, length, blocks = int(port["n_factors"]), int(port["history_len"]), int(port["sasrec_blocks"])
    dev = gen.device
    bound = d ** -0.5

    def lin(fan_out):
        u = torch.rand((d * fan_out + fan_out,), generator=gen, device=dev) * (2 * bound) - bound
        return {"w": u[: d * fan_out].reshape(d, fan_out).clone(), "b": u[d * fan_out:].clone()}

    def ln():
        z = torch.randn((2, d), generator=gen, device=dev) * 0.1
        return {"scale": 1.0 + z[0], "bias": z[1].clone()}

    out = {"blocks": [
        {"qkv": lin(3 * d), "attn_out": lin(d), "ffn1": lin(d), "ffn2": lin(d), "ln1": ln(), "ln2": ln()}
        for _ in range(blocks)
    ]}
    out["ln_out"] = ln()
    out["pos"] = torch.randn((length, d), generator=gen, device=dev) / d
    return out


def clone_dense(dense):
    return _rebuild(dense, {k: v.clone() for k, v in flatten(dense).items()})


def aux(train_users: np.ndarray, train_items: np.ndarray, n_users: int, n_items: int, port: Dict, device) -> Dict:
    """What a step needs besides the weights: every user's history window
    and the number of heads."""
    idx, mask = histories(train_users, train_items, n_users, int(port["history_len"]))
    return {"hist": torch.as_tensor(idx, device=device), "hist_mask": torch.as_tensor(mask, device=device),
            "heads": int(port["sasrec_heads"])}


def dense_views(dense) -> Dict[str, torch.Tensor]:
    """Each dense parameter by its path; the packed q, k, v projections as
    three parameters (``...qkv.w:q`` etc.), since each is one mathematically
    (the key bias, for one, gets no gradient: a constant added to every key
    score of a row)."""
    out = {}
    for path, t in flatten(dense).items():
        if path.endswith(("qkv.w", "qkv.b")):
            for name, part in zip("qkv", torch.chunk(t, 3, dim=-1)):
                out[f"{path}:{name}"] = part
        else:
            out[path] = t
    return out


def histories(train_users: np.ndarray, train_items: np.ndarray, n_users: int, length: int):
    """(n_users, L) item rows and mask: each user's last L train items in
    the split's order, left-aligned."""
    n = len(train_users)
    order = np.lexsort((np.arange(n), train_users))  # by user, then split position
    su, si = train_users[order], train_items[order]
    count = np.bincount(su, minlength=n_users)
    end = np.cumsum(count)  # one past each user's last row in su
    idx = np.zeros((n_users, length), np.int64)
    mask = np.zeros((n_users, length), bool)
    for j in range(length):  # slot j holds the (min(count, L) - j)-th item from the end
        from_end = np.minimum(count, length) - j
        ok = from_end > 0
        rows = end[ok] - from_end[ok]
        idx[ok, j] = si[rows]
        mask[ok, j] = True
    return idx, mask


def _ln(x, p):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + LN_EPS) * p["scale"] + p["bias"]


def encode(dense, hist: torch.Tensor, mask: torch.Tensor, heads: int, low: bool) -> torch.Tensor:
    """(B, L, d) history rows, (B, L) mask -> (B, d) user vectors."""
    b, length, d = hist.shape
    dh = d // heads
    keep = mask[..., None].float()
    x = (hist + dense["pos"][:length][None]) * keep
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=hist.device))
    bias = torch.where(causal[None] & mask[:, None, :], 0.0, -1e9)[:, None]  # (B, 1, L, L)

    def lin(p, z):
        return mm(z, p["w"], low) + p["b"]

    for blk in dense["blocks"]:
        z = _ln(x, blk["ln1"])
        q, k, v = (t.reshape(b, length, heads, dh).transpose(1, 2)
                   for t in torch.chunk(lin(blk["qkv"], z), 3, dim=-1))
        att = torch.softmax(mm(q, k.transpose(-1, -2), low) / dh ** 0.5 + bias, dim=-1)
        ctx = mm(att, v, low).transpose(1, 2).reshape(b, length, d)
        x = x + lin(blk["attn_out"], ctx)
        x = x + lin(blk["ffn2"], torch.relu(lin(blk["ffn1"], _ln(x, blk["ln2"]))))
        x = x * keep
    x = _ln(x, dense["ln_out"])
    pos = torch.arange(length, device=hist.device)
    last = torch.where(mask, pos[None], -1).max(dim=1).values
    h = x[torch.arange(b, device=hist.device), last.clamp_min(0)]
    return torch.where((last >= 0)[:, None], h, torch.zeros_like(h))


def _rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, f"{prefix}{k}.") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(t, flat, f"{prefix}{i}.") for i, t in enumerate(tree)]
    return flat[prefix[:-1]]


def train_steps(tables: Dict[str, torch.Tensor], dense, batches, lr: float, aux: Dict,
                low: bool = False, half: bool = False) -> Dict:
    """Logistic steps from ``tables`` and ``dense`` (copied) over
    ``batches`` (dicts of ``user``, ``pos``, ``neg``, ``w``,
    ``weight_sum``); ``aux``: ``hist`` and ``hist_mask`` (device tensors of
    :func:`histories`) and ``heads``. ``low`` and ``half`` as in mf.py.
    Returns each step's loss, the first step's gradient norms (tables over
    their gathered occurrences, dense parameters by :func:`dense_views`)
    and every parameter's change after the last step."""
    t = {k: v.clone() for k, v in tables.items()}
    acc = {k: torch.zeros(v.shape[0], dtype=torch.float32, device=v.device) for k, v in t.items()}
    params = {k: v.clone() for k, v in flatten(dense).items()}
    opt: Dict = {"m": {}, "v": {}}
    losses, grad_norms = [], {}
    for step, bt in enumerate(batches):
        u, pos, neg, w = bt["user"], bt["pos"], bt["neg"], bt["w"]
        b = u.shape[0]
        hist = aux["hist"][u]
        mask = aux["hist_mask"][u] & (hist != pos[:, None])
        items = torch.cat([pos, neg])
        q = t["item"][items].requires_grad_()
        qb = t["item_bias"][items].requires_grad_()
        hr = t["item"][hist].requires_grad_()
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with ieee_f32():
            h = encode(_rebuild(dense, leaves), hr, mask, aux["heads"], low)
            s = (h.repeat(2, 1) * q).sum(dim=-1) + qb[:, 0]
        per_row = -0.5 * (F.logsigmoid(s[:b]) + F.logsigmoid(-s[b:]))
        if half:
            loss = per_row[: b // 2].mean()
        else:
            loss = torch.sum(per_row * w) / max(float(bt["weight_sum"]), 1.0)
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [q, qb, hr] + [leaves[k] for k in keys])
        g_q, g_qb, g_h = grads[:3]
        g_dense = dict(zip(keys, grads[3:]))
        losses.append(float(loss.detach()))
        if step == 0:
            grad_norms = {"item": float(torch.sqrt((g_q ** 2).sum() + (g_h ** 2).sum())),
                          "item_bias": float(g_qb.norm())}
            grad_norms.update({k: float(v.norm()) for k, v in dense_views(_rebuild(dense, g_dense)).items()})
        with torch.no_grad():
            rowwise_adagrad(t["item"], acc["item"], [(items, g_q), (hist, g_h)], lr)
            rowwise_adagrad(t["item_bias"], acc["item_bias"], [(items, g_qb)], lr)
            adam(params, g_dense, opt, lr)
    change = {k: float((t[k] - tables[k]).norm()) for k in TABLES}
    before, after = dense_views(dense), dense_views(_rebuild(dense, params))
    change.update({k: float((after[k] - before[k]).norm()) for k in before})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

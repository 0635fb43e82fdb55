"""Plain reference of matrix factorisation with biases (the port's Linear
net without metadata): ``score(u, i) = <p_u, q_i> + b_u + b_i``.

Serving: every item's score for the request's users, in IEEE float32.
Training with in-batch sampled softmax: row r of a batch scores its user
against every positive of the batch, ``s_rc = <p_r, q_c> + b_c - log
freq(c)`` (the logQ correction: the train split's item frequency), a
column holding the same item as row r's own positive, off the diagonal, is
masked out, and the loss is ``mean_r(logsumexp_c s_rc - s_rr)``. The user
bias is constant along a row, so it drops out and takes no step. Each
embedding row then takes rowwise adagrad per gathered occurrence.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference.plain import ieee_f32, mm, rowwise_adagrad

TABLES = ("item", "item_bias", "user", "user_bias")


def make_tables(shapes: Dict[str, Tuple[int, int]], gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded tables in the shapes given (padded rows), drawn on the
    generator's device: factors N(0, d^-1/2), so that a score has unit
    spread as a trained model's do (the N(0, 1/d^2) of a fresh model ties
    every item to three digits), biases N(0, 0.1^2)."""
    if set(shapes) != set(TABLES):
        raise ValueError(f"tables {sorted(shapes)} are not MF's {sorted(TABLES)}")
    out = {}
    for name in TABLES:
        rows, dim = shapes[name]
        std = 0.1 if dim == 1 else dim ** -0.25
        out[name] = torch.randn((rows, dim), generator=gen, device=gen.device) * std
    return out


def catalog_scores(tables: Dict[str, torch.Tensor], users: torch.Tensor, n_items: int,
                   low: bool = False) -> torch.Tensor:
    """(U, N) scores of ``users`` (rows) against the whole catalog."""
    with ieee_f32():
        s = mm(tables["user"][users], tables["item"][:n_items].T, low)
    return s + tables["item_bias"][:n_items, 0][None, :] + tables["user_bias"][users, 0][:, None]


def topk(scores: torch.Tensor, k: int):
    """(values, indices) of each row's k best scores: value descending,
    then index ascending among equal values."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def logq(train_items: np.ndarray, n_items: int, device) -> torch.Tensor:
    """log of each item's share of the train split (a floor of 1e-12 keeps
    absent items finite; they never appear as a column)."""
    counts = np.bincount(train_items, minlength=n_items).astype(np.float64)
    q = counts / max(counts.sum(), 1.0)
    return torch.as_tensor(np.log(np.maximum(q, 1e-12)), dtype=torch.float32, device=device)


def make_dense(port: Dict, gen: torch.Generator):
    """MF has no dense parameters."""
    return {}


def clone_dense(dense):
    return {}


def dense_views(dense) -> Dict[str, torch.Tensor]:
    return {}


def aux(train_users: np.ndarray, train_items: np.ndarray, n_users: int, n_items: int, port: Dict, device) -> Dict:
    """What a step needs besides the weights: the logQ correction."""
    return {"logq": logq(train_items, n_items, device)}


def train_steps(tables: Dict[str, torch.Tensor], dense, batches, lr: float, aux: Dict,
                low: bool = False, half: bool = False) -> Dict:
    """In-batch softmax steps from ``tables`` (copied) over ``batches``
    (dicts of ``user``, ``pos``, ``w``, ``weight_sum``). ``low``: the
    products in TF32 (the control); ``half``: the loss over the first half
    of each batch only (a fault). Returns each step's loss, the first
    step's gradient norm of each table over its gathered occurrences, and
    each table's change after the last step."""
    t = {k: v.clone() for k, v in tables.items()}
    acc = {k: torch.zeros(v.shape[0], dtype=torch.float32, device=v.device) for k, v in t.items()}
    lq = aux["logq"]
    losses, grad_norms = [], {}
    for step, bt in enumerate(batches):
        u, p, w = bt["user"], bt["pos"], bt["w"]
        hu = t["user"][u].requires_grad_()
        vi = t["item"][p].requires_grad_()
        vb = t["item_bias"][p].requires_grad_()
        with ieee_f32():
            logits = mm(hu, vi.T, low) + vb[:, 0][None, :] - lq[p][None, :]
        b = u.shape[0]
        eye = torch.eye(b, dtype=torch.bool, device=u.device)
        logits = logits.masked_fill((p[None, :] == p[:, None]) & ~eye, -torch.inf)
        per_row = torch.logsumexp(logits, dim=1) - logits.diagonal()
        if half:
            loss = per_row[: b // 2].mean()
        else:
            loss = torch.sum(per_row * w) / max(float(bt["weight_sum"]), 1.0)
        g_u, g_i, g_b = torch.autograd.grad(loss, [hu, vi, vb])
        losses.append(float(loss.detach()))
        if step == 0:
            grad_norms = {"user": float(g_u.norm()), "item": float(g_i.norm()),
                          "item_bias": float(g_b.norm()), "user_bias": 0.0}
        with torch.no_grad():
            rowwise_adagrad(t["user"], acc["user"], [(u, g_u)], lr)
            rowwise_adagrad(t["item"], acc["item"], [(p, g_i)], lr)
            rowwise_adagrad(t["item_bias"], acc["item_bias"], [(p, g_b)], lr)
    change = {k: float((t[k] - tables[k]).norm()) for k in TABLES}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

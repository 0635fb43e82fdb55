"""Two-tower retrieval walkthrough (port of
``examples/retrieval_training.py``): in-batch sampled softmax -> factor
export -> external-ANN-style serving.

1. train with ``loss='sampled_softmax'``: every batch row's positive is
   every other row's negative, logQ-corrected for item popularity;
2. export the factorization with ``item_vectors()`` / ``user_vectors()``;
3. serve with any ANN engine via the standard MIPS augmentation (index
   ``[q_i, b_i]``, query ``[u, 1]``), shown here with plain numpy and
   checked against ``predict``.

Also shown: WARP (LightFM's loss) with popularity-weighted negatives as
the alternative pairwise objective.

    python -m torchrecsys_tpu_torch.examples.retrieval_training [--device cpu]

On the card the softmax steps launch the in-batch CE forward and backward
kernels, and recall@k, ndcg@k and ``predict`` the fused score + top-k
kernel.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from torchrecsys_tpu_torch import RecSys


def synthetic(n_users=3000, n_items=2000, n=150_000, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    blocks = users % 8
    items = blocks * (n_items // 8) + rng.integers(0, n_items // 8, n)
    return {"user_id": users, "item_id": items}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the walkthrough; returns the RecSys objects it built."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=3000)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--rows", type=int, default=150_000)
    args = ap.parse_args(argv)

    data = synthetic(args.users, args.items, args.rows)

    # ---- 1. retrieval training --------------------------------------------
    model = RecSys(data, "user_id", "item_id", n_factors=48,
                   net_type="linear", dynamic_neg_sampling=True, device=args.device)
    # batch_size doubles as the negative count: each example competes
    # against the other 1023 in-batch items
    model.fit(epochs=5, batch_size=1024, learning_rate=0.05,
              loss="sampled_softmax", verbose=False)
    print("eval:", model.evaluate(
        eval_metrics=("auc", "recall@10", "ndcg@10"), verbose=False))

    # ---- 2. factor export --------------------------------------------------
    item_vecs, item_bias = model.item_vectors()       # (N, 48), (N,)
    user_vecs, _ = model.user_vectors([0, 1, 2])      # (3, 48)
    print(f"exported: items {item_vecs.shape}, bias {item_bias.shape}")

    # ---- 3. ANN-style serving (numpy stands in for ScaNN/FAISS) ------------
    index = np.concatenate([item_vecs, item_bias[:, None]], axis=1)  # [q, b]
    queries = np.concatenate([user_vecs, np.ones((3, 1), np.float32)], axis=1)
    ann_top = np.argsort(-(queries @ index.T), axis=1, kind="stable")[:, :10]
    exact = np.asarray(model.predict([0, 1, 2], top_k=10, return_raw_ids=False))
    assert (ann_top == exact).all(), "ANN ranking must match predict exactly"
    print("ANN top-10 == predict top-10 for all query users")

    # ---- alternative: WARP with popularity-weighted negatives --------------
    warp = RecSys(data, "user_id", "item_id", n_factors=48,
                  net_type="linear", dynamic_neg_sampling=True, device=args.device)
    warp.fit(epochs=5, batch_size=1024, learning_rate=0.05, loss="warp",
             num_negatives=8, neg_sampling="popularity", verbose=False)
    print("warp eval:", warp.evaluate(
        eval_metrics=("auc", "recall@10"), verbose=False))
    return {"model": model, "warp": warp}


if __name__ == "__main__":
    main()

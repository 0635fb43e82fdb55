"""Quickstart mirroring the reference README flow (port of
``examples/quickstart.py``): build a dataset with metadata, train an FM,
evaluate, and get top-k recommendations.

    python -m torchrecsys_tpu_torch.examples.quickstart [--device cpu]

On the card the FM's metadata steps run the row-level pairwise kernel's
bf16 variant (``use_amp=True``) and ``predict`` the fused score + top-k
kernel on the bf16 catalog.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from torchrecsys_tpu_torch import RecSys


def synthetic_interactions(n_users=2000, n_items=500, n=200_000, seed=0):
    """Synthetic dataset with real preference structure: users prefer items
    sharing their favourite category."""
    rng = np.random.default_rng(seed)
    n_cats = 16
    item_cat = rng.integers(0, n_cats, n_items)
    user_pref = rng.integers(0, n_cats, n_users)
    users = rng.integers(0, n_users, n)
    # 70% of interactions hit an item from the user's preferred category:
    # draw a random item, then map it into the preferred category's item set
    items = rng.integers(0, n_items, n)
    on_pref = rng.random(n) < 0.7
    cat_members = [np.flatnonzero(item_cat == c) for c in range(n_cats)]
    pick = rng.integers(0, n_items, n)
    for c in range(n_cats):
        if len(cat_members[c]) == 0:
            continue
        rows = np.flatnonzero(on_pref & (user_pref[users] == c))
        items[rows] = cat_members[c][pick[rows] % len(cat_members[c])]
    return {
        "user_id": users,
        "product_id": items,
        "category_ids": np.asarray([[int(c)] for c in item_cat[items]], dtype=object),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the walkthrough; returns the RecSys objects it built."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=500)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "torchrecsys_tpu_torch_quickstart_ckpt"))
    args = ap.parse_args(argv)

    data = synthetic_interactions(args.users, args.items, args.rows)
    model = RecSys(
        data,
        user_id_col="user_id",
        item_id_col="product_id",
        metadata_id_col=["category_ids"],
        n_factors=64,
        net_type="fm",
        dynamic_neg_sampling=True,
        use_amp=True,
        device=args.device,
    )
    print("dataset:", model.config)
    model.fit(optimizer="adam", epochs=5, batch_size=1024, learning_rate=0.05,
              loss="bpr")
    model.evaluate(eval_metrics=["loss", "auc"])
    user = int(data["user_id"][0])
    print(f"top-10 for user {user}:", model.predict(user_id=user, top_k=10))
    print("batch predict:", model.predict(user_id=[0, 1, 2], top_k=5).shape)
    model.save(args.ckpt)
    print("checkpoint saved.")
    return {"model": model}


if __name__ == "__main__":
    main()

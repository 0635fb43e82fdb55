"""Production-serving walkthrough (port of
``examples/production_serving.py``): train, checkpoint, cold-load, serve.

Covers the serving-side capabilities the quickstart skips: full-catalog
ranking (``approx_recall`` is accepted and exact in the port), seen-item
filtering, large result lists, item-item similarity, and incremental
catalog growth, the lifecycle a production recommender runs:

    train -> save -> (new process) load -> predict variants -> new data
    arrives -> update_data + refit -> predict again

    python -m torchrecsys_tpu_torch.examples.production_serving [--device cpu]

On the card the Linear hinge steps run the fused pairwise step kernel,
and serving the fused score + top-k kernel (its list variant above k=16).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np

from torchrecsys_tpu_torch import RecSys


def synthetic(n_users=3000, n_items=2000, n=150_000, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n) * 7 + 13  # raw ids: any ints work
    blocks = users % 8
    items = (blocks * (n_items // 8) + rng.integers(0, n_items // 8, n)) * 3
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

    # ---- train + checkpoint ------------------------------------------------
    model = RecSys(data, "user_id", "item_id", n_factors=48, net_type="linear",
                   dynamic_neg_sampling=True, device=args.device)
    model.fit(epochs=5, batch_size=2048, learning_rate=0.05, verbose=False)
    print("eval:", model.evaluate(eval_metrics=["auc", "recall@10"],
                                  verbose=False))

    with tempfile.TemporaryDirectory(prefix="recsys_ckpt_") as ckpt:
        model.save(ckpt)

        # ---- cold start: a fresh serving process needs only the directory --
        serving = RecSys.load(ckpt, device=args.device)
    some_user = int(data["user_id"][0])

    # exact full-catalog top-k (the fused score + top-k kernel on the card)
    top10 = serving.predict(some_user, top_k=10)
    print("top-10:", top10)

    # large result lists route through the kernel's list variant (k > 16)
    top200 = serving.predict(some_user, top_k=200)
    print("top-200 head:", top200[:5], "...", len(top200), "items")

    # approx_recall is accepted and exact in the port (the JAX package's
    # approximate top-k is the TPU's hardware operation)
    fast10 = serving.predict(some_user, top_k=10, approx_recall=0.95)
    print("approx top-10:", fast10)

    # item-item similarity from the trained factors
    some_item = int(top10[0])
    print("similar to", some_item, "->", serving.similar_items(some_item, top_k=5))

    # ---- incremental: new interactions arrive (new users AND new items) ----
    fresh = {
        "user_id": np.asarray([999_001] * 6),
        "item_id": np.asarray([0, 3, 6, 9, 12, 600_001]),  # one brand-new item
    }
    # warm process: update_data grows vocabularies + trained state in place;
    # cold-loaded processes work too (encoders thaw for the extension)
    model.update_data(fresh)
    model.fit(epochs=2, batch_size=2048, verbose=False)

    # the new user now gets recommendations, with their own items excluded:
    # the items of their train split (the seeded split may send some of the
    # new rows to the test split, and those items stay eligible)
    recs = model.predict(999_001, top_k=5, exclude_seen=True)
    print("new user recs (seen excluded):", recs)
    store = model.store
    row = store.user_encoder.encode_one(999_001)
    seen = {int(x) for x in store.item_encoder.decode(store.train_items[store.train_users == row])}
    assert seen and not set(int(x) for x in recs) & seen
    return {"model": model, "serving": serving}


if __name__ == "__main__":
    main()

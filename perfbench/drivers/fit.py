"""Generic driver of training traffic through the port's trainer.

A traffic file of this kind gives ``train`` (the TrainConfig keywords:
batch size, learning rate, loss, optimizers, negative sampling) and
``launches`` (each launch counter's expected count per step). The
configuration file gives the data (lib/gen.py), ``port`` (the ModelConfig
keywords) and ``reference`` (the plain reference module).

Set-up builds one training object, the trainer with its model and the
state around tables (and dense parameters) made from the seed here, and
trains one epoch, ``Trainer.fit(epochs=1)``, the call the window makes.
The window then calls it again, epoch after epoch, and ends at the first
epoch end after ``--seconds``: the rate is every real training row of
those epochs over the whole window, epoch builds and uploads included.

The check follows the set-up epoch's first three steps. The program's
readings are taken as those steps run (through the step method, which
the trainer calls by name): each step's loss, the first step's gradient
norm of every leaf as its optimizer got it (rowwise adagrad: its
accumulators after one step, which add each gathered occurrence's mean
square; adam: its first moment over 1 - beta1), and every leaf's change
after the third step. The reference runs the same three steps from the
same seeded weights on the same rows. It takes the rows and negatives of
each step from the program's epoch: the epoch's order comes from the
program's own generator. That stage is checked by itself: the epoch's
real rows are the train split's rows, each once, sorted by user within a
batch, with negatives in the catalog and apart from their positive; and
the train and test splits together are the generated interactions under
the documented encoding.
"""

from __future__ import annotations

import gc
import inspect
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.lib import counters, device as devmod, gen
from perfbench.lib.check import Check, training_numbers
from perfbench.lib.record import Run
from perfbench.lib.trace import Window
from perfbench.reference.plain import ADAM_B1

CHECK_STEPS = 3


class _Capture:
    """Wraps the trainer's step method for the first CHECK_STEPS steps of
    the set-up epoch, and its epoch builder for that epoch."""

    def __init__(self, trainer, step_name: str, tables, dense, ref) -> None:
        self.trainer, self.step_name, self.ref = trainer, step_name, ref
        self.tables0, self.dense0 = tables, ref.dense_views(dense)
        self.orig = getattr(trainer, step_name)
        self.sig = inspect.signature(self.orig)
        self.orig_build = trainer.build_epoch
        self.batches, self.losses = [], []
        self.grad_norms, self.change_norms = {}, {}
        self.epoch = None
        self.overhead_s = 0.0
        setattr(trainer, step_name, self._step)
        trainer.build_epoch = self._build

    def _build(self, *a, **kw):
        self.epoch = self.orig_build(*a, **kw)
        del self.trainer.build_epoch
        return self.epoch

    def _step(self, *a, **kw):
        args = self.sig.bind(*a, **kw).arguments
        t0 = time.perf_counter()
        user, pos = args["user"], args["pos"]
        w = args.get("w")
        b = user.shape[0]
        self.batches.append({
            "user": user.clone(), "pos": pos.clone(),
            "neg": args["neg"].clone() if "neg" in args else None,
            "w": torch.ones(b, device=user.device) if w is None else w.float().clone(),
            "weight_sum": float(b if args.get("weight_sum") is None else args["weight_sum"]),
        })
        self.overhead_s += time.perf_counter() - t0
        loss = self.orig(*a, **kw)
        t0 = time.perf_counter()
        self.losses.append(float(loss))
        aug, state = args["aug"], args["state"]
        with torch.no_grad():
            if len(self.batches) == 1:
                for name, t in aug.items():  # acc after one step: sum of occurrences' mean squares
                    d = t.shape[1] - 1
                    self.grad_norms[name] = math.sqrt(d * float(t[:, -1].double().sum()))
                mu = (state.get("dense_opt") or {}).get("mu")
                views = self.ref.dense_views(mu) if mu is not None else {k: None for k in self.dense0}
                for k, m in views.items():  # no first moment: the optimizer got no gradient
                    self.grad_norms[k] = 0.0 if m is None else float(m.norm()) / (1 - ADAM_B1)
            if len(self.batches) == CHECK_STEPS:
                for name, t in aug.items():
                    self.change_norms[name] = float((t[:, :-1] - self.tables0[name]).norm())
                for k, p in self.ref.dense_views(state["dense"]).items():
                    self.change_norms[k] = float((p - self.dense0[k]).norm())
                delattr(self.trainer, self.step_name)
        self.overhead_s += time.perf_counter() - t0
        return loss

    def epoch_host(self):
        """The set-up epoch's batches on the host; drops the device copy."""
        bt = self.epoch.batches
        out = {k: bt[k].cpu().numpy() for k in ("user_id", "pos_item_id", "neg_item_id", "_w") if k in bt}
        self.epoch = None
        return out

    def readings(self):
        return {"losses": self.losses, "grad_norms": self.grad_norms, "change_norms": self.change_norms}


def _keys(users, items, n_items: int) -> np.ndarray:
    return np.sort(users.astype(np.int64) * n_items + items.astype(np.int64))


def split_bad(data, vocab_u, vocab_i, split, ratio: float) -> int:
    """0 when train + test are the generated interactions under the
    documented encoding and train holds round(ratio x n) of them."""
    n_items = len(vocab_i)
    want = _keys(np.searchsorted(vocab_u, data["user_id"]), np.searchsorted(vocab_i, data["item_id"]), n_items)
    got = _keys(np.concatenate([split["train_u"], split["test_u"]]),
                np.concatenate([split["train_i"], split["test_i"]]), n_items)
    bad = int(not np.array_equal(want, got))
    return bad + int(len(split["train_u"]) != int(round(len(want) * ratio)))


def epoch_bad(ep, split, n_items: int) -> int:
    """Faults of the set-up epoch: its real rows are not the train split's
    rows (1), batches not sorted by user (one each), negatives outside the
    catalog or equal to their positive (one each)."""
    u, p = ep["user_id"], ep["pos_item_id"]
    real = ep["_w"] > 0 if "_w" in ep else np.ones(u.shape, bool)
    bad = int(not np.array_equal(_keys(u[real], p[real], n_items),
                                 _keys(split["train_u"], split["train_i"], n_items)))
    bad += int((np.diff(u, axis=1) < 0).any(axis=1).sum())
    if "neg_item_id" in ep:
        neg = ep["neg_item_id"]
        bad += int(((neg < 0) | (neg >= n_items) | (neg == p)).sum())
    return bad


def run(cell, ctx, ref):
    from torchrecsys_tpu_torch.config import ModelConfig, TrainConfig
    from torchrecsys_tpu_torch.data.interactions import prepare_data
    from torchrecsys_tpu_torch.models import build_model
    from torchrecsys_tpu_torch.models.base import padded_rows
    from torchrecsys_tpu_torch.train.optim import init_embedding_opt
    from torchrecsys_tpu_torch.train.trainer import Trainer

    cfg, tr = cell.config, cell.traffic
    dev = ctx.device
    parts = {"start": time.perf_counter() - ctx.t0}
    t = time.perf_counter()
    data = gen.interactions(cfg["data"], ctx.seed)
    parts["data"] = time.perf_counter() - t
    t = time.perf_counter()
    train_kw = dict(tr["train"])
    ratio = float(cfg["data"]["split_ratio"])
    store = prepare_data({"user_id": data["user_id"], "item_id": data["item_id"]}, "user_id", "item_id",
                         split_ratio=ratio, dynamic_neg_sampling=bool(train_kw.get("dynamic_neg_sampling")),
                         seed=(ctx.seed & gen.SEED_MASK) + 42)
    model = build_model(store.schema, ModelConfig(**cfg["port"])).to(dev)
    trainer = Trainer(model, TrainConfig(seed=ctx.seed & gen.SEED_MASK, **train_kw), dev)
    parts["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    shapes = {k: (padded_rows(s.rows), s.dim) for k, s in model.table_specs().items()}
    tables = ref.make_tables(shapes, gen.torch_gen(ctx.seed, 1, dev))
    dense = ref.make_dense(cfg["port"], gen.torch_gen(ctx.seed, 5, dev))
    state = {
        "tables": {k: v.clone() for k, v in tables.items()},
        "dense": ref.clone_dense(dense),
        "model_state": model.init_state(dev),
        "emb_opt": init_embedding_opt("rowwise_adagrad", tables),
        "dense_opt": None,
        "step": 0,
    }
    step_name = "softmax_step" if train_kw["loss"] == "sampled_softmax" else "pairwise_step"
    cap = _Capture(trainer, step_name, tables, dense, ref)
    parts["tables"] = time.perf_counter() - t
    t = time.perf_counter()
    state, _ = trainer.fit(state, store, epochs=1, verbose=False)
    parts["first_epoch"] = time.perf_counter() - t - cap.overhead_s
    t0 = time.perf_counter()
    epoch0 = cap.epoch_host()
    excluded = cap.overhead_s + time.perf_counter() - t0
    setup_s = time.perf_counter() - ctx.t0 - excluded
    ctx.log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; the check's capture {excluded:.3f} s, not counted")

    n_train = store.num_train
    b = min(int(train_kw["batch_size"]), n_train)
    nb = -(-n_train // b)
    names = list(tr["launches"])
    before = counters.read(names)
    epochs = 0
    with Window(ctx.traced, dev) as win:
        end = win.start + ctx.seconds
        while True:
            state, _ = trainer.fit(state, store, epochs=1, verbose=False)
            epochs += 1
            if time.perf_counter() >= end:
                break
        win.close()
    after = counters.read(names)
    port = cfg["port"]
    record = Run("fit", cfg, tr, setup_s=setup_s, window_s=win.seconds, epochs=epochs, steps=epochs * nb,
                 examples=epochs * n_train, launches={n: after[n] - before[n] for n in names},
                 shapes={"B": b, "D": int(port["n_factors"]), "L": int(port.get("history_len", 0)),
                         "blocks": int(port.get("sasrec_blocks", 0)), "dtype": cfg["dtype"],
                         "net": port["net_type"]},
                 trace=win.trace)
    ctx.log(f"launches in the window: {record.launches} over {record.steps} steps ({epochs} epochs)")
    missed = counters.misses(tr["launches"], before, after, record.steps)
    dev_info = devmod.info(dev, cell.chips) if dev.type == "cuda" else None
    ctx.window_closed()

    split = {"train_u": np.asarray(store.train_users), "train_i": np.asarray(store.train_items),
             "test_u": np.asarray(store.test_users), "test_i": np.asarray(store.test_items)}
    batches = cap.batches[:CHECK_STEPS]
    prog = cap.readings()
    del state, trainer, model, store, cap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    vocab_u, _ = gen.encoding(data["user_id"])
    vocab_i, _ = gen.encoding(data["item_id"])
    check = Check(cell.limits)
    check.add("split_bad", split_bad(data, vocab_u, vocab_i, split, ratio))
    check.add("epoch_bad", epoch_bad(epoch0, split, len(vocab_i)))
    aux = ref.aux(split["train_u"], split["train_i"], len(vocab_u), len(vocab_i), port, dev)
    lr = float(train_kw["learning_rate"])
    want = ref.train_steps(tables, dense, batches, lr, aux)
    nums = training_numbers(prog, want)
    for k in ("loss_gap", "grad_gap", "change_gap"):
        check.add(k, nums[k])
    check.notes.append(f"beside them: worst step's loss gap {nums['worst_loss_gap']!r}, worst leaves' grad gap "
                       f"{nums['worst_grad_gap']!r} ({nums['_grad_leaf']}) and change gap {nums['worst_change_gap']!r} "
                       f"({nums['_change_leaf']}); losses program {prog['losses']} reference {want['losses']}")

    def control():
        """The control (the reference in TF32) and the half-batch fault,
        each in the program's place, read against the reference."""
        out = {}
        for name, kw in (("tf32", {"low": True}), ("half_batch", {"half": True})):
            got = ref.train_steps(tables, dense, batches, lr, aux, **kw)
            nums_c = training_numbers(got, want)
            out[name] = {k: v for k, v in nums_c.items() if not k.startswith("_")}
        out["sound"] = {k: v for k, v in nums.items() if not k.startswith("_")}
        return out

    return SimpleNamespace(record=record, check=check, device=dev_info, missed=missed, control=control)

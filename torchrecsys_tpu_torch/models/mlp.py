"""Two-tower-concat MLP model (port of ``torchrecsys_tpu/models/mlp.py``).

``score = out(relu(BN(... relu(BN(x @ W0 + b0)) ...)))`` over ``x = user ⊕
item ⊕ the masked mean of each metadata feature's embeddings``
(mlp.py:99-152). Batch norm is functional: batch statistics in training,
running statistics (momentum 0.1, eps 1e-5, the unbiased variance) in
eval, threaded through ``state = {"bn": [{"mean", "var"}, ...]}``.

Training in bf16 compute with batch norm runs every hidden layer through
the fused layer kernels (ops/fused_tower.py: the layer's matmul with the
next layer's batch sums in its epilogue, and its fused backward), as
``_score_rows_fused`` (mlp.py:154-202) does; f32 compute and eval take
the plain tower (``torch.matmul``, as the JAX package leaves it to XLA).

On a mesh whose ``data`` axis splits the batch, the training statistics
cover the global batch, as JAX's ``jnp.mean`` over the ``data``-sharded
rows does: the trainer passes ``batch["_bn_sum"]``, which takes this
rank's Σx and Σx² of a layer and its row count and returns the sums over
``data`` (parallel/mesh.py::sum_shares, differentiable) and the global
count. Both towers divide by that count; in the fused tower the
reduction sits between kernel #6's sums and the next layer, so autograd
hands kernel #7 the cotangents of the global sums.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from torchrecsys_tpu_torch.models.base import (
    Batch,
    RecModel,
    State,
    TableSpec,
    masked_mean,
    uniform_linear_init,
)
from torchrecsys_tpu_torch.ops import fused_tower as ft

_BN_MOMENTUM = 0.1
_BN_EPS = 1e-5


def _running(bn_s: Dict[str, torch.Tensor], mean: torch.Tensor, var: torch.Tensor, n: int):
    """torch-momentum running statistics with the unbiased batch variance."""
    unbiased = var * (n / max(n - 1, 1))
    return {
        "mean": (1 - _BN_MOMENTUM) * bn_s["mean"] + _BN_MOMENTUM * mean,
        "var": (1 - _BN_MOMENTUM) * bn_s["var"] + _BN_MOMENTUM * unbiased,
    }


def _global_sums(reduce, s: torch.Tensor, ss: torch.Tensor, n: int):
    """(Σx, Σx²) of this rank's n rows -> ((Σx, Σx²) of the global batch,
    its row count), in one collective."""
    sums, n = reduce(torch.stack([s, ss]), n)
    return sums.unbind(0), n


class MLPModel(RecModel):
    name = "mlp"
    user_gather_sites = frozenset({"user"})

    def table_specs(self) -> Dict[str, TableSpec]:
        d = self.cfg.n_factors
        s = self.schema
        specs = {
            "user": TableSpec(s.num_users, d, "scaled"),
            "item": TableSpec(s.num_items, d, "scaled"),
        }
        for fname, vocab in zip(s.metadata_names, s.metadata_vocab_sizes):
            specs[f"meta_{fname}"] = TableSpec(max(vocab, 1), d, "scaled")
        return specs

    def _input_width(self) -> int:
        # 2 * n_factors + n_factors per metadata feature (mlp.py:56-58)
        return self.cfg.n_factors * (2 + len(self.schema.metadata_names))

    def init_dense(self, generator: torch.Generator) -> Any:
        """``{"layers": [{"w" (fan_in, fan_out), "b"}], "out", "bn":
        [{"scale", "bias"}]}`` (mlp.py:60-76)."""
        widths = [self._input_width(), *self.cfg.hidden_layers]
        dt, dev = self.param_dtype, generator.device
        layers: List[Dict[str, torch.Tensor]] = [
            uniform_linear_init(generator, fan_in, fan_out, dt)
            for fan_in, fan_out in zip(widths[:-1], widths[1:])
        ]
        dense: Dict[str, Any] = {
            "layers": layers,
            "out": uniform_linear_init(generator, widths[-1], 1, dt),
        }
        if self.cfg.use_batch_norm:
            dense["bn"] = [
                {"scale": torch.ones((w,), dtype=dt, device=dev),
                 "bias": torch.zeros((w,), dtype=dt, device=dev)}
                for w in widths[1:]
            ]
        return dense

    def init_state(self, device: Any = None) -> State:
        if not self.cfg.use_batch_norm:
            return {}
        return {
            "bn": [
                {"mean": torch.zeros((w,), dtype=torch.float32, device=device),
                 "var": torch.ones((w,), dtype=torch.float32, device=device)}
                for w in self.cfg.hidden_layers
            ]
        }

    def gathers(self, batch: Batch) -> Dict[str, Tuple[str, torch.Tensor]]:
        g = {
            "user": ("user", batch["user_id"]),
            "item": ("item", batch["item_id"]),
        }
        g.update(self._meta_gathers(batch))
        return g

    def score_rows(
        self, dense: Any, state: State, rows: Dict[str, torch.Tensor], batch: Batch,
        train: bool = False,
    ) -> Tuple[torch.Tensor, State]:
        cd = self.compute_dtype
        parts = [rows["user"].to(cd), rows["item"].to(cd)]
        for f, fname in enumerate(self.schema.metadata_names[: self._meta_features(batch)]):
            m = rows[f"meta:{fname}"].to(cd)  # (B, W, D)
            parts.append(masked_mean(m, batch["meta_mask"][:, f, :]))
        x = torch.cat(parts, dim=-1)
        reduce = batch.get("_bn_sum") if train else None
        if train and cd == torch.bfloat16 and ft.tower_applicable(self.cfg):
            return self._score_rows_fused(dense, state, x, reduce)

        use_bn = self.cfg.use_batch_norm
        new_bn = []
        for li, layer in enumerate(dense["layers"]):
            x = x @ layer["w"].to(cd) + layer["b"].to(cd)
            if use_bn:
                bn_p, bn_s = dense["bn"][li], state["bn"][li]
                if train:
                    # one pass: mean and E[x^2] in f32 over the bf16 or f32
                    # activation, var = E[x^2] - mean^2 (mlp.py:127-143)
                    n = x.shape[0]
                    if reduce is None:
                        mean = torch.mean(x, dim=0, dtype=torch.float32)
                        msq = torch.mean(x * x, dim=0, dtype=torch.float32)
                    else:  # over the global batch
                        sums, n = _global_sums(reduce, torch.sum(x, dim=0, dtype=torch.float32),
                                               torch.sum(x * x, dim=0, dtype=torch.float32), n)
                        mean, msq = sums[0] / n, sums[1] / n
                    var = torch.clamp_min(msq - mean * mean, 0.0)
                    new_bn.append(_running(bn_s, mean, var, n))
                else:
                    mean, var = bn_s["mean"], bn_s["var"]
                inv = torch.rsqrt(var + _BN_EPS).to(cd)
                x = (x - mean.to(cd)) * inv
                x = x * bn_p["scale"].to(cd) + bn_p["bias"].to(cd)
            x = torch.relu(x)
        score = x @ dense["out"]["w"].to(cd) + dense["out"]["b"].to(cd)
        new_state = {"bn": new_bn} if (use_bn and train) else state
        return score[:, 0].float(), new_state

    def _score_rows_fused(
        self, dense: Any, state: State, x: torch.Tensor, reduce=None
    ) -> Tuple[torch.Tensor, State]:
        """The training tower through the fused layer (mlp.py:154-202): per
        hidden layer one :func:`~torchrecsys_tpu_torch.ops.fused_tower.
        fused_layer` (the layer's matmul with its output's Σz and Σz² in the
        epilogue; BN and ReLU of its input inside), then the statistics math
        in plain torch (on a mesh after ``reduce``), then the head."""
        cd = self.compute_dtype
        n = x.shape[0]
        new_bn = []
        bnvec = torch.zeros((4, x.shape[1]), dtype=cd, device=x.device)
        z = x
        for li, layer in enumerate(dense["layers"]):
            z, s, ss = ft.fused_layer(z, layer["w"].to(cd), layer["b"].to(cd), bnvec, li > 0)
            if reduce is not None:
                (s, ss), n = _global_sums(reduce, s, ss, x.shape[0])
            mean = s / n
            var = torch.clamp_min(ss / n - mean * mean, 0.0)
            new_bn.append(_running(state["bn"][li], mean, var, n))
            inv = torch.rsqrt(var + _BN_EPS).to(cd)
            bn_p = dense["bn"][li]
            bnvec = torch.stack([mean.to(cd), inv, bn_p["scale"].to(cd), bn_p["bias"].to(cd)])
        h = torch.relu((z - bnvec[0]) * bnvec[1] * bnvec[2] + bnvec[3])
        score = h @ dense["out"]["w"].to(cd) + dense["out"]["b"].to(cd)
        return score[:, 0].float(), {"bn": new_bn}

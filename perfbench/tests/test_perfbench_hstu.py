"""The HSTU cell (``hstu_fit_bce_b8192``) at a CPU size: its files resolve
by name, its plain reference (reference/hstu.py) runs and agrees with the
port's encoder, imports nothing of the port, and a whole tiny run reads
``correct: false`` with the timed path broken (the loss over half of each
batch; the relative position bias left out of the port's encoder)."""

import json
import math

import pytest
import torch

import torchrecsys_tpu_torch.models.hstu as hstu_mod
import torchrecsys_tpu_torch.train.trainer as trainer_mod
from perfbench.lib import gen, roofline, spec
from perfbench.lib.roofline_hstu import hstu_flops_per_example
from perfbench.reference import hstu as ref
from perfbench.tests import _tiny
from perfbench.tests.test_perfbench_imports import _python

CELL = "hstu_fit_bce_b8192"


def test_cell_resolves_to_its_files():
    c = spec.resolve(CELL)
    assert (c.config_name, c.traffic_name, c.chips) == ("hstu_large_ml1m", "fit_bce_b8192_hstu", 1)
    assert c.config["reference"] == "hstu" and spec.reference(c).__name__ == "perfbench_reference_hstu"
    port = c.config["port"]
    assert port == {"net_type": "hstu", "n_factors": 50, "history_len": 200, "hstu_blocks": 8, "hstu_heads": 2}
    assert (c.config["dqk"], c.config["dv"]) == (25, 25) and c.config["num_heads"] * c.config["dqk"] == 50
    assert c.traffic["train"] == spec.load_json(f"{spec.BENCH}/traffic/fit_bce_b8192.json")["train"]
    # 2 norms x 8 blocks a step through kernel #8, forward and backward; no other kernel
    launches = c.traffic["launches"]
    assert launches.pop("ops.layer_norm.layer_norm_fwd") == launches.pop("ops.layer_norm.layer_norm_bwd") == 16
    assert set(launches.values()) == {0} and len(launches) == 9
    assert set(c.limits) == {"split_bad", "epoch_bad", "loss_gap", "grad_gap", "change_gap"}
    names = {m["name"] for m in c.end_to_end + c.per_layer}
    assert {"setup_s", "fit_examples_per_s", "mfu_hstu.fit", "hstu_encode_host_ms.fit"} <= names
    assert "mfu.fit" not in names


def test_model_flops():
    d, length, blocks = 50, 200, 8
    per_block = 10 * length * d * d + 4 * length * length * d
    assert hstu_flops_per_example(d, length, blocks, 2) == 3 * (blocks * per_block + 4 * d)
    assert hstu_flops_per_example(d, length, blocks, 1) == hstu_flops_per_example(d, length, blocks, 2)
    assert hstu_flops_per_example(d, length, blocks, 2) / roofline.sasrec_flops_per_example(50, 50, 2) > 25


def test_reference_runs_tiny_and_agrees_with_the_port():
    from torchrecsys_tpu_torch.config import DataSchema, ModelConfig
    from torchrecsys_tpu_torch.models import build_model

    port = {"net_type": "hstu", "n_factors": 8, "history_len": 6, "hstu_blocks": 2, "hstu_heads": 2}
    g = gen.torch_gen(2**40 + 1, 5, "cpu")
    dense = ref.make_dense(port, g)
    model = build_model(DataSchema(20, 30), ModelConfig(**port))
    assert {k: tuple(v.shape) for k, v in ref.flatten(dense).items()} == \
        {k: tuple(v.shape) for k, v in ref.flatten(model.init_dense(g)).items()}
    emb = torch.randn((16, 6, 8), generator=g) * 0.3
    mask = torch.rand((16, 6), generator=g) > 0.3
    mask[0] = False
    want = ref.encode(dense, emb, mask, 2, low=False)
    torch.testing.assert_close(model._encode(dense, emb, mask), want, rtol=1e-5, atol=2e-6)
    assert not want[0].any()
    low = ref.encode(dense, emb, mask, 2, low=True)
    assert 1e-6 < float((low - want).abs().max()) < 1e-2  # TF32 moves it, by TF32's rounding

    tables = ref.make_tables({"item": (64, 8), "item_bias": (64, 1)}, g)
    users = torch.arange(12) % 5
    items = torch.arange(60) % 30
    aux = ref.aux(users.numpy(), items[:12].numpy(), 5, 30, port, "cpu")
    batches = [{"user": users, "pos": items[i:i + 12], "neg": (items[i:i + 12] + 7) % 30,
                "w": torch.ones(12), "weight_sum": 12.0} for i in range(3)]
    got = ref.train_steps(tables, dense, batches, 0.01, aux)
    assert len(got["losses"]) == 3 and all(math.isfinite(x) for x in got["losses"])
    assert set(got["grad_norms"]) == set(ref.dense_views(dense)) | {"item", "item_bias"}
    # a step taken in chunks is the step taken whole
    whole = ref.CHUNK
    try:
        ref.CHUNK = 5
        chunked = ref.train_steps(tables, dense, batches, 0.01, aux)
    finally:
        ref.CHUNK = whole
    for k in ("losses",):
        assert chunked[k] == pytest.approx(got[k], rel=1e-6)
    for k, v in got["grad_norms"].items():
        assert chunked["grad_norms"][k] == pytest.approx(v, rel=1e-5, abs=1e-9), k


def test_reference_imports_nothing_of_the_port():
    code = (f"import sys, json\nsys.path.insert(0, {spec.ROOT!r})\nimport perfbench.reference.hstu\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0].startswith('torchrecsys'))))")
    assert json.loads(_python(code)) == []


def test_half_batch_fault_is_not_correct(monkeypatch):
    share = trainer_mod.Trainer._share

    def half(self, per_row, w, weight_sum, rows):
        return share(self, per_row[: per_row.shape[0] // 2], None, None, rows)

    monkeypatch.setattr(trainer_mod.Trainer, "_share", half)
    result, out = _tiny.run(_tiny.cell(CELL))
    assert not result["correct"]
    assert out.check.as_dict()["loss_gap"]["value"] > out.check.as_dict()["loss_gap"]["limit"]


def test_encoder_without_its_relative_bias_is_not_correct(monkeypatch):
    monkeypatch.setattr(hstu_mod, "relative_bias", lambda w, n: torch.zeros((n, n), dtype=w.dtype) * w[0])
    result, out = _tiny.run(_tiny.cell(CELL))
    assert not result["correct"]
    checks = out.check.as_dict()
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"]

"""CPU tests of the benchmark's own arithmetic and files: the generators,
the roofline and FLOP counts, the reference's top-k order, and that every
cell of BENCHMARK.json resolves to its files by name."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.lib import gen, roofline, spec
from perfbench.lib.check import Check, leaf_gaps, training_numbers
from perfbench.lib.trace import DeviceTrace
from perfbench.reference import mf

DATA = {"n_users": 50, "n_items": 80, "n_interactions": 2000, "blocks": 8, "on_block": 0.7}


def test_interactions_are_deterministic_by_seed():
    a, b, c = gen.interactions(DATA, 5), gen.interactions(DATA, 5), gen.interactions(DATA, 6)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["item_id"], c["item_id"])


def test_interactions_hold_every_id_under_scrambled_raw_ids():
    d = gen.interactions(DATA, 2**40 + 3)
    assert len(d["user_id"]) == DATA["n_interactions"]
    vocab_u, rows_u = gen.encoding(d["user_id"])
    vocab_i, rows_i = gen.encoding(d["item_id"])
    assert (len(vocab_u), len(vocab_i)) == (DATA["n_users"], DATA["n_items"])
    # raw ids are not in the generator's order: the encoding is exercised
    assert not np.array_equal(rows_u, d["_u"]) and not np.array_equal(rows_i, d["_i"])
    # one raw id per generator index
    assert len(np.unique(np.stack([d["_i"], d["item_id"]]), axis=1)[0]) == DATA["n_items"]
    np.testing.assert_array_equal(gen.rows_of(vocab_i, np.array([vocab_i[3], -5])), [3, -1])


def test_request_users_are_distinct_and_seeded():
    r1, r2 = gen.np_rng(9, 2), gen.np_rng(9, 2)
    for _ in range(20):
        a, b = gen.request_users(r1, 300, 256), gen.request_users(r2, 300, 256)
        np.testing.assert_array_equal(a, b)
        assert len(np.unique(a)) == 256 and a.min() >= 0 and a.max() < 300


def test_weights_are_deterministic_by_seed():
    shapes = {"user": (64, 8), "item": (128, 8), "user_bias": (64, 1), "item_bias": (128, 1)}
    a = mf.make_tables(shapes, gen.torch_gen(2**35, 1, "cpu"))
    b = mf.make_tables(shapes, gen.torch_gen(2**35, 1, "cpu"))
    c = mf.make_tables(shapes, gen.torch_gen(2**35 + 1, 1, "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["item"], c["item"])


def test_roofline_bounds_match_the_kernel_table():
    # the port's kernel table: #1/#2 at U=256, N=1M, D=80, f32 (3xTF32 at 165 TFLOP/s): 0.2482 ms
    assert roofline.topk_bound_s(256, 1_000_000, 80, 10, "float32") * 1e3 == pytest.approx(0.2482, abs=5e-5)
    assert roofline.topk_bound_s(256, 1_000_000, 80, 128, "float32") * 1e3 == pytest.approx(0.2482, abs=5e-5)
    # #4 / #5 at B=4096, D=80: 0.0163 / 0.0488 ms
    assert roofline.ce_fwd_bound_s(4096, 80) * 1e3 == pytest.approx(0.0163, abs=5e-5)
    assert roofline.ce_bwd_bound_s(4096, 80) * 1e3 == pytest.approx(0.0488, abs=5e-5)
    # on a bf16 catalog the item stream bounds #1 (0.0490 ms in the table)
    assert roofline.topk_bound_s(256, 1_000_000, 80, 10, "bfloat16") * 1e3 == pytest.approx(0.0490, abs=5e-4)


def test_model_flops():
    assert roofline.mf_softmax_flops_per_example(16384, 80) == 6 * 16384 * 80
    d, length, blocks = 50, 50, 2
    per_block = 2 * length * d * 3 * d + 2 * length * length * d * 2 + 2 * length * d * d + 2 * 2 * length * d * d
    assert roofline.sasrec_flops_per_example(d, length, blocks) == 3 * (blocks * per_block + 2 * 2 * d)


def test_reference_topk_order_is_value_then_index():
    s = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9], [1.0, 1.0, 1.0, 1.0, 2.0]])
    values, idx = mf.topk(s, 4)
    assert idx.tolist() == [[1, 2, 4, 0], [4, 0, 1, 2]]
    assert torch.equal(values, torch.gather(s, 1, idx))


def test_every_cell_resolves_to_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.resolve(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert os.path.exists(os.path.join(spec.BENCH, "drivers", f"{c.traffic['driver']}.py"))
        assert os.path.exists(os.path.join(spec.BENCH, "reference", f"{c.config['reference']}.py"))
        assert c.end_to_end and c.per_layer
        names = [m["name"] for m in c.end_to_end + c.per_layer]
        assert "setup_s" in names
        for n in names:
            assert callable(spec.metric_reader(n))
        assert all(isinstance(v, (int, float)) for v in c.limits.values())
    for cfg in bench["configs"]:
        body = spec.load_json(os.path.join(spec.ROOT, cfg["file"]))
        assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]


def test_benchmark_json_keeps_to_its_contract():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_check_and_training_numbers():
    c = Check({"a": 1.0, "b": 0})
    c.add("a", 0.5)
    c.add("b", 0)
    assert c.correct
    c.add("a", float("nan"))
    assert not c.correct
    gaps = leaf_gaps({"x": 1.1, "y": 0.0}, {"x": 1.0, "y": 1e-9}, ["x", "y"])
    assert gaps["x"] == pytest.approx(0.1)  # over x's own norm, the larger
    assert gaps["y"] == pytest.approx(1e-9 / 0.5000000005)  # over the median leaf's
    ref = {"losses": [1.0, 2.0, 3.0], "grad_norms": {"a": 1.0, "b": 1e-9, "c": 2.0},
           "change_norms": {"a": 2.0, "b": 5.0, "c": 1.0}}
    prog = dict(ref, losses=[1.0, 2.2, 3.0], change_norms={"a": 2.0, "b": 0.0, "c": 1.5})
    got = training_numbers(prog, ref)
    assert got["loss_gap"] == 0.0 and got["worst_loss_gap"] == pytest.approx(0.1)  # step 1; the worst
    # b's gradient is nought to rounding: its change is not compared; a reads 0, c 0.5 / 2 (the
    # median change norm), and their median is half of that
    assert got["change_gap"] == pytest.approx(0.125) and got["worst_change_gap"] == pytest.approx(0.25)


def test_device_trace_reduction():
    ms = 1_000_000
    tr = DeviceTrace([("void k1<float>(int)", 0, 2 * ms), ("k2", 1 * ms, 3 * ms), ("k3", 5 * ms, 6 * ms)], 0.01)
    assert tr.busy_s == pytest.approx(0.004)
    assert tr.gaps == {"k2 -> k3": pytest.approx(0.002)}
    assert tr.ops()["k1"] == pytest.approx(0.002)
    assert tr.seconds("k") == pytest.approx(0.005)

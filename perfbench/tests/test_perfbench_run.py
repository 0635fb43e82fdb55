"""A run of each cell, cut to a CPU size (tests/_tiny.py), end to end but
for the look for a card: correct on sound code, and not correct with the
timed path broken underneath in each way the cell can break. The control
(the reference in TF32 in the program's place) reads above the sound run
on the same inputs."""

import pytest

import torchrecsys_tpu_torch.ops.dot_topk as dt
import torchrecsys_tpu_torch.train.trainer as trainer_mod
from perfbench.lib import spec
from perfbench.tests import _tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SERVE = [c for c in CELLS if spec.resolve(c).traffic["driver"] == "serve"]
FIT = [c for c in CELLS if spec.resolve(c).traffic["driver"] == "fit"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, out = _tiny.run(_tiny.cell(name))
    assert result["correct"], out.check.lines()
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in _tiny.cell(name).end_to_end}
    assert result["attempted"] > 0 and not out.forbidden


@pytest.mark.parametrize("name", SERVE)
def test_served_id_altered_where_produced_is_not_correct(name, monkeypatch):
    plain = dt.dot_topk_plain

    def altered(*a, **kw):
        vals, ids = plain(*a, **kw)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % a[1].shape[0]  # one answer per user changed
        return vals, ids

    monkeypatch.setattr(dt, "dot_topk_plain", altered)
    result, out = _tiny.run(_tiny.cell(name))
    assert not result["correct"]
    assert out.check.as_dict()["topk_gap"]["value"] > out.check.as_dict()["topk_gap"]["limit"]


@pytest.mark.parametrize("name", FIT)
def test_step_that_leaves_its_state_unchanged_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(trainer_mod, "apply_embedding_updates_fused", lambda *a, **kw: None)
    monkeypatch.setattr(trainer_mod.Trainer, "_dense_step", lambda self, *a, **kw: None)
    result, out = _tiny.run(_tiny.cell(name))
    assert not result["correct"]
    checks = out.check.as_dict()
    assert checks["grad_gap"]["value"] == pytest.approx(1.0)
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", FIT)
def test_step_over_half_the_batch_is_not_correct(name, monkeypatch):
    share = trainer_mod.Trainer._share

    def half(self, per_row, w, weight_sum, rows):
        n = per_row.shape[0] // 2
        return share(self, per_row[:n], None, None, rows)

    monkeypatch.setattr(trainer_mod.Trainer, "_share", half)
    result, out = _tiny.run(_tiny.cell(name))
    assert not result["correct"]
    assert out.check.as_dict()["loss_gap"]["value"] > out.check.as_dict()["loss_gap"]["limit"]


@pytest.mark.parametrize("name", FIT)
def test_training_control_and_fault_read_above_the_sound_run(name):
    _, out = _tiny.run(_tiny.cell(name))
    got = out.control()
    sound = got["sound"]
    assert got["tf32"]["grad_gap"] > 10 * max(sound["grad_gap"], 1e-9)
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert got["half_batch"][k] > 10 * max(sound[k], 1e-9)


@pytest.mark.parametrize("name", SERVE)
def test_serving_control_reads_above_the_sound_run(name):
    # enough items that TF32's rounding reorders near ties
    c = _tiny.cell(name, n_users=400, n_items=60_000, n_interactions=70_000)
    result, out = _tiny.run(c)
    assert result["correct"]
    got = out.control()["tf32"]
    assert got["topk_gap"] > 10 * max(out.check.as_dict()["topk_gap"]["value"], 1e-7)


def test_forbidden_modules_compare_whole_top_level_names():
    from perfbench.lib.device import forbidden_modules

    assert forbidden_modules(["torchrecsys_tpu_torch", "torchrecsys_tpu_torch.api", "jaxtyping"]) == []
    assert forbidden_modules(["torchrecsys_tpu.api", "jax._src", "numpy"]) == ["jax", "torchrecsys_tpu"]

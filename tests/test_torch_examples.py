"""The port's examples (torchrecsys_tpu_torch/examples/) against the JAX
package's (examples/): no example imports JAX or the JAX package, each
compiles, each data generator gives the JAX example's arrays, and each
``main`` runs on the CPU at a small size with its own asserts held
(``multihost_train`` as a world of one)."""

import ast
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest

EXAMPLES = ("quickstart", "retrieval_training", "production_serving", "multihost_train")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "torchrecsys_tpu_torch", "examples")
SMALL = ["--device", "cpu", "--users", "150", "--items", "64", "--rows", "5000"]


def _port(name):
    return importlib.import_module(f"torchrecsys_tpu_torch.examples.{name}")


def _jax_example(name):
    """The JAX package's example module, imported from its file (it puts
    the repository root on ``sys.path``, restored here)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_example_{name}", os.path.join(ROOT, "examples",
                                                                                      f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_and_compiles(name):
    path = os.path.join(PORT_DIR, f"{name}.py")
    with open(path) as f:
        src = f.read()
    compile(src, path, "exec")
    for node in ast.walk(ast.parse(src)):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "torchrecsys_tpu"), f"{name} imports {m}"
    assert callable(_port(name).main)


@pytest.mark.parametrize("name, fn, kw", [
    ("quickstart", "synthetic_interactions", {}),
    ("quickstart", "synthetic_interactions", dict(n_users=150, n_items=64, n=5000, seed=2)),
    ("retrieval_training", "synthetic", {}),
    ("production_serving", "synthetic", {}),
    ("production_serving", "synthetic", dict(n_users=150, n_items=64, n=5000)),
])
def test_data_generator_matches_jax_example(name, fn, kw):
    got, want = getattr(_port(name), fn)(**kw), getattr(_jax_example(name), fn)(**kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multihost_data_matches_jax_example():
    """The JAX example builds its data inline in ``main``
    (examples/multihost_train.py:63-67); the port's ``synthetic`` is that
    code."""
    r = np.random.default_rng(0)
    rows = 200_000
    want = {"user_id": r.integers(0, 10_000, rows), "item_id": r.integers(0, 5_000, rows)}
    got = _port("multihost_train").synthetic(rows)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["quickstart", "retrieval_training", "production_serving"])
def test_example_main_runs_small_on_the_cpu(name, tmp_path, capsys):
    argv = SMALL + (["--ckpt", str(tmp_path / "ckpt")] if name == "quickstart" else [])
    _port(name).main(argv)
    out = capsys.readouterr().out
    if name == "quickstart":
        assert os.path.exists(tmp_path / "ckpt" / "state.pt") and "checkpoint saved." in out
        assert "[torchrecsys_tpu_torch.train] eval: loss=" in out
    elif name == "retrieval_training":
        assert "ANN top-10 == predict top-10 for all query users" in out and "warp eval:" in out
    else:
        assert "new user recs (seen excluded):" in out


def test_multihost_runs_as_a_world_of_one(capsys):
    _port("multihost_train").main(["--device", "cpu", "--rows", "20000"])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith(("losses:", "eval:"))]
    assert len(lines) == 2
    losses = [float(x) for x in lines[0].removeprefix("losses: [").rstrip("]").split(",")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "'auc'" in lines[1]
    with pytest.raises(SystemExit):
        _port("multihost_train").main(["--num-processes", "2", "--process-id", "0", "--device", "cpu"])

"""SASRec on the port (torchrecsys_tpu_torch/models/sasrec.py,
models/sequence.py) against the JAX package's ``SASRecModel``, through the
helpers and at the tolerances of tests/test_torch_lstm.py (d=8, L=5, two
blocks of two heads unless a test says otherwise).

The fits train the dense tree with adagrad, except one with adam (the
facade's default) that holds the key bias to its own bound
(tests/test_torch_lstm.py::_assert_dense): several attention weights get
gradients near zero that the two packages round differently, and adam
divides each by its own magnitude, so their steps differ by far more than
the rounding; adagrad keeps the difference at the rounding's scale."""

import numpy as np
import pytest
import torch

from torchrecsys_tpu_torch.config import ModelConfig
from torchrecsys_tpu_torch.data import prepare_data
from torchrecsys_tpu_torch.models import build_model
from torchrecsys_tpu_torch.models.sasrec import _layer_norm

from tests.test_torch_lstm import (
    AMP_DENSE_OPT,
    check_card_launches,
    check_encode,
    check_evaluate,
    check_fit,
    check_jax_checkpoint_carried_across,
    check_pack_store_aux_history,
    check_pair_vectors,
    check_predict,
    check_score_rows,
    cuda_device,  # noqa: F401  (the fixture)
    seq_data,
)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["left_padded", "interleaved", "empty"])
def test_encode_matches_jax(kind, compute):
    check_encode("sasrec", kind, compute)


@pytest.mark.parametrize("k", [0, 1, 3], ids=["generic", "paired_k1", "paired_k3"])
def test_score_rows_match_jax(k):
    check_score_rows("sasrec", k)


def test_pair_vectors_match_jax():
    check_pair_vectors("sasrec")


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_f32_epochs_match_jax(loss):
    check_fit("sasrec", loss, "float32", dense_optimizer="adagrad")


def test_f32_epochs_match_jax_one_block_four_heads():
    check_fit("sasrec", "hinge", "float32", dense_optimizer="adagrad", sasrec_blocks=1, sasrec_heads=4)


def test_f32_epochs_match_jax_under_adam():
    check_fit("sasrec", "hinge", "float32", sasrec_blocks=1)


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_amp_epochs_track_jax(loss):
    check_fit("sasrec", loss, "bfloat16", dense_optimizer=AMP_DENSE_OPT)


@pytest.mark.parametrize("loss", ["hinge", "sampled_softmax"])
def test_evaluate_matches_jax(loss):
    check_evaluate("sasrec", loss)


def test_predict_matches_jax():
    check_predict("sasrec")


def test_pack_store_aux_history_matches_jax():
    check_pack_store_aux_history("sasrec")


def test_jax_checkpoint_carried_across(tmp_path):
    check_jax_checkpoint_carried_across("sasrec", tmp_path)


def test_positions_are_dense_and_the_heads_must_divide():
    """``pos`` is a (history_len, d) dense leaf, not a table; the layer
    norm is the JAX package's (eps 1e-6, biased variance)."""
    store = prepare_data(seq_data(), "user_id", "item_id")
    m = build_model(store.schema, ModelConfig(net_type="sasrec", n_factors=8, history_len=7, sasrec_blocks=3))
    dense = m.init_dense(torch.Generator().manual_seed(0))
    assert tuple(dense["pos"].shape) == (7, 8) and set(m.table_specs()) == {"item", "item_bias"}
    assert len(dense["blocks"]) == 3 and tuple(dense["blocks"][0]["qkv"]["w"].shape) == (8, 24)
    x = torch.randn(4, 8, dtype=torch.float64)
    want = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-6)
    torch.testing.assert_close(_layer_norm(x, torch.ones(8, dtype=x.dtype), torch.zeros(8, dtype=x.dtype)), want)
    with pytest.raises(ValueError, match="divisible by sasrec_heads=3"):
        build_model(store.schema, ModelConfig(net_type="sasrec", n_factors=8, sasrec_heads=3))


@pytest.mark.gpu
def test_card_launches_the_kernels(cuda_device):  # noqa: F811
    check_card_launches("sasrec", cuda_device)


def test_bf16_mask_bias_rounds_like_jax():
    """-1e9 in bf16 is -998244352: the mask is added in the compute dtype,
    before the f32 softmax, so a masked key still gets weight 0."""
    assert float(torch.tensor(-1e9).to(torch.bfloat16)) == -998244352.0
    store = prepare_data(seq_data(), "user_id", "item_id")
    m = build_model(store.schema, ModelConfig(net_type="sasrec", n_factors=8, history_len=5,
                                              compute_dtype="bfloat16"))
    dense = m.init_dense(torch.Generator().manual_seed(1))
    emb = torch.randn(3, 5, 8)
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], dtype=torch.bool)
    h = m._encode(dense, emb, mask)
    assert h.dtype == torch.bfloat16 and torch.isfinite(h.float()).all() and not h[2].any()
    # the encoding of row 0 ignores what sits under its padding
    emb2 = emb.clone()
    emb2[0, 2:] = 100.0
    assert torch.equal(m._encode(dense, emb2, mask)[0], h[0])
    assert np.isfinite(h.float().numpy()).all()

"""torchrecsys_tpu_torch -- the PyTorch/CUDA port of torchrecsys_tpu.

The port lives beside the JAX package and imports nothing from it. This
slice serves: ``RecSys(data)`` -> ``load_jax_tables(...)`` ->
``predict(users, top_k)``, with the fused score + top-k as hand-written
Hopper kernels (ops/csrc/dot_topk.cu). Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from torchrecsys_tpu_torch.api import RecSys

__all__ = ["RecSys", "__version__"]

"""torchrecsys_tpu_torch -- the PyTorch/CUDA port of torchrecsys_tpu.

The port lives beside the JAX package and imports nothing from it. It
does what the JAX package does behind the same ``RecSys`` surface: id
encoding, metadata and the seeded split; the seven nets (linear, fm, mlp,
neucf, lstm, sasrec, ease) and HSTU, its own; the pairwise, K-negative and sampled-softmax
losses with rowwise-adagrad embeddings; evaluation; full-catalog top-k
serving; checkpoints, incremental training, the streaming fit, every net
on a ('data', 'model') mesh of ranks; logging, profiling and the
examples. Each TPU kernel of the JAX package is a hand-written Hopper
kernel (ops/csrc/: the fused score + top-k, the fused pairwise step, the
in-batch softmax CE forward and backward, the BN-tower layer forward and
backward), each with its plain torch version beside it for CPU tensors.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from torchrecsys_tpu_torch.api import RecSys

__all__ = ["RecSys", "__version__"]

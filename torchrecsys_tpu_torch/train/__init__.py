"""Training: pairwise losses, rowwise-adagrad layout helpers, the Trainer."""

from torchrecsys_tpu_torch.train.trainer import Trainer

__all__ = ["Trainer"]

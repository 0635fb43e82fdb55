"""Training: pairwise losses, rowwise-adagrad layout helpers, the Trainer
and the streaming fit."""

from torchrecsys_tpu_torch.train.streaming import SuperBatchStream, fit_streaming
from torchrecsys_tpu_torch.train.trainer import Trainer

__all__ = ["SuperBatchStream", "Trainer", "fit_streaming"]

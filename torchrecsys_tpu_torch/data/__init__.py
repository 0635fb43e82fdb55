"""Host data layer: id encoding, metadata buckets, the interaction store."""

from torchrecsys_tpu_torch.data.interactions import InteractionStore, prepare_data

__all__ = ["InteractionStore", "prepare_data"]

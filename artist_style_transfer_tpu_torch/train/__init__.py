"""Training: ``train()`` for the Gram modes and the classifier mode, its loop, targets and
checkpoints; Gatys."""

from artist_style_transfer_tpu_torch.train.api import train, train_from_config

__all__ = ["train", "train_from_config"]

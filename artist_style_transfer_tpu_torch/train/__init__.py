"""Training: ``train()`` for the Gram modes and the classifier mode, its loop, targets and
checkpoints; Gatys; and :mod:`classifier`, which trains the ResNet-50 artist classifier
itself (the upstream workflow behind ``models/best-2.pth``, reference README.md:34-35)."""

from artist_style_transfer_tpu_torch.train.api import train, train_from_config

__all__ = ["train", "train_from_config"]

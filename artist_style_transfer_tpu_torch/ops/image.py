"""Image-space ops (counterpart of the JAX ``ops/image.py``, the stylize/Gatys subset).

Resize, affine rescale, center crop and torchvision normalization belong to
the evaluation path and are not ported yet. Functions take NHWC or HWC
tensors (channels last axis), as the JAX package's do.
"""

from __future__ import annotations

import torch

# Caffe-style VGG mean, BGR order (reference train_cnn.py:164-165).
CAFFE_BGR_MEAN = (103.939, 116.779, 123.68)


def bgr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Flip the last (channel) axis between BGR and RGB."""
    return x.flip(-1)


def vgg_caffe_preprocess(x_bgr_255: torch.Tensor) -> torch.Tensor:
    """Subtract the BGR ImageNet mean for Caffe-style VGG input (NHWC/HWC).

    Input BGR/[0,255], no scaling, no std (reference train_cnn.py:164).
    """
    mean = torch.tensor(CAFFE_BGR_MEAN, dtype=x_bgr_255.dtype, device=x_bgr_255.device)
    return x_bgr_255 - mean

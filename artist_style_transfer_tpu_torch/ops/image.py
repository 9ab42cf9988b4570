"""Image-space ops (counterpart of the JAX ``ops/image.py``): colour conversion,
Caffe preprocessing, torchvision normalization and center crop.

Bilinear resize and affine rescale serve only the JPEG loaders, and come
with them. Functions take NHWC or HWC tensors (channels last axis), as the
JAX package's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Caffe-style VGG mean, BGR order (reference train_cnn.py:164-165).
CAFFE_BGR_MEAN = (103.939, 116.779, 123.68)

# torchvision ImageNet stats, RGB order (reference inference.py:58-59). The
# reference's classifier-mode *training* has 0.546 for the G mean, a typo
# (train_cnn.py:272), which ``reference_typo_stats=True`` reproduces.
TORCHVISION_MEAN_RGB = (0.485, 0.456, 0.406)
TORCHVISION_TYPO_MEAN_RGB = (0.485, 0.546, 0.406)
TORCHVISION_STD_RGB = (0.229, 0.224, 0.225)


def bgr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Flip the last (channel) axis between BGR and RGB."""
    return x.flip(-1)


def vgg_caffe_preprocess(x_bgr_255: torch.Tensor) -> torch.Tensor:
    """Subtract the BGR ImageNet mean for Caffe-style VGG input (NHWC/HWC).

    Input BGR/[0,255], no scaling, no std (reference train_cnn.py:164).
    """
    mean = torch.tensor(CAFFE_BGR_MEAN, dtype=x_bgr_255.dtype, device=x_bgr_255.device)
    return x_bgr_255 - mean


def torchvision_normalize(x_rgb_01: torch.Tensor, reference_typo_stats: bool = False) -> torch.Tensor:
    """(x - mean) / std with the torchvision ImageNet stats, RGB [0,1] input, in x's dtype.

    ``transforms.Normalize`` of the reference's eval transform (inference.py:58)
    and its training helper (train_cnn.py:85-98); ``reference_typo_stats=True``
    takes the training path's 0.546 G mean.
    """
    mean = TORCHVISION_TYPO_MEAN_RGB if reference_typo_stats else TORCHVISION_MEAN_RGB
    kw = dict(dtype=x_rgb_01.dtype, device=x_rgb_01.device)
    return (x_rgb_01 - torch.tensor(mean, **kw)) / torch.tensor(TORCHVISION_STD_RGB, **kw)


def center_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop to (size, size) as ``transforms.CenterCrop`` (inference.py:57); HWC or NHWC.

    An image smaller than ``size`` is zero-padded first, the odd pixel on the
    top/left; the crop's offset is ``(h - size) // 2``. The result is a view
    where no padding was needed.
    """
    h_axis = image.dim() - 3
    h, w = image.shape[h_axis], image.shape[h_axis + 1]
    pad_h, pad_w = max(size - h, 0), max(size - w, 0)
    if pad_h or pad_w:
        # F.pad lists the last axis first: C, then W, then H.
        image = F.pad(image, (0, 0, pad_w - pad_w // 2, pad_w // 2, pad_h - pad_h // 2, pad_h // 2))
        h, w = image.shape[h_axis], image.shape[h_axis + 1]
    top, left = (h - size) // 2, (w - size) // 2
    return image.narrow(h_axis, top, size).narrow(h_axis + 1, left, size)

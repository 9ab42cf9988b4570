"""Ops of the port: padding, image, conv, norm, Gram, int8 conv and losses (NCHW inside,
NHWC at the Gram); the re-exports of the JAX ``ops`` package."""

from artist_style_transfer_tpu_torch.ops.gram import gram_matrix  # noqa: F401
from artist_style_transfer_tpu_torch.ops.image import (  # noqa: F401
    CAFFE_BGR_MEAN,
    TORCHVISION_MEAN_RGB,
    TORCHVISION_STD_RGB,
    affine_rescale,
    bgr_to_rgb,
    center_crop,
    resize_bilinear,
    rgb_to_bgr,
    torchvision_normalize,
    vgg_caffe_preprocess,
)
from artist_style_transfer_tpu_torch.ops.norm import (  # noqa: F401
    batch_norm_inference,
    instance_norm,
)
from artist_style_transfer_tpu_torch.ops.pad import reflect_pad_hw  # noqa: F401

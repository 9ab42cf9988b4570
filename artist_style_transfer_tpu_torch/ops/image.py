"""Image-space ops (counterpart of the JAX ``ops/image.py``): colour conversion,
Caffe preprocessing, torchvision normalization, bilinear resize, the reference's
affine rescale and center crop.

Functions take NHWC or HWC tensors (channels last axis), as the JAX
package's do. The JPEG loaders (``data/``) decode and resample on the host
with OpenCV or the native pool; ``resize_bilinear`` and ``affine_rescale``
are the same resamplings on tensors, held against JAX and cv2.
"""

from __future__ import annotations

import functools

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


def rgb_to_bgr(x: torch.Tensor) -> torch.Tensor:
    """Flip the last (channel) axis between RGB and BGR (its own inverse)."""
    return x.flip(-1)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple[float, ...], dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once per (values, dtype, device).

    Read-only. Made from the Python tuple on every call, it would be a
    synchronous host-to-device copy, which waits for the device to finish all
    queued work: twice a streamed training step, three times a 'classifier'
    step. Made outside inference mode, so that autograd may save it even when
    the first call came from an ``inference_mode`` block.
    """
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def vgg_caffe_preprocess(x_bgr_255: torch.Tensor) -> torch.Tensor:
    """Subtract the BGR ImageNet mean for Caffe-style VGG input (NHWC/HWC).

    Input BGR/[0,255], no scaling, no std (reference train_cnn.py:164).
    """
    return x_bgr_255 - _constant(CAFFE_BGR_MEAN, x_bgr_255.dtype, x_bgr_255.device)


def torchvision_normalize(x_rgb_01: torch.Tensor, reference_typo_stats: bool = False) -> torch.Tensor:
    """(x - mean) / std with the torchvision ImageNet stats, RGB [0,1] input, in x's dtype.

    ``transforms.Normalize`` of the reference's eval transform (inference.py:58)
    and its training helper (train_cnn.py:85-98); ``reference_typo_stats=True``
    takes the training path's 0.546 G mean.
    """
    mean = TORCHVISION_TYPO_MEAN_RGB if reference_typo_stats else TORCHVISION_MEAN_RGB
    dtype, dev = x_rgb_01.dtype, x_rgb_01.device
    return (x_rgb_01 - _constant(mean, dtype, dev)) / _constant(TORCHVISION_STD_RGB, dtype, dev)


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


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize to (height, width) with half-pixel centres, no antialiasing; HWC or NHWC.

    JAX's ``jax.image.resize(..., "linear", antialias=False)``, and
    ``cv2.resize`` INTER_LINEAR up to cv2's fixed-point rounding (reference
    dataset.py:101). At the border both clamp the source coordinate to the
    edge pixel, as ``F.interpolate(align_corners=False)`` does.
    """
    if image.dim() not in (3, 4):
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(image.shape)}")
    x = (image[None] if image.dim() == 3 else image).permute(0, 3, 1, 2)
    out = F.interpolate(x.float(), size=(height, width), mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    return out[0] if image.dim() == 3 else out


def _affine_rescale_matrix(src_h: int, src_w: int, dst_h: int, dst_w: int):
    """(w_s, h_s, tx, ty) of the reference ``rescale``'s forward affine (dataset.py:36-52):
    dst_x = w_s * x + tx, dst_y = h_s * y + ty, a scale about the image centre."""
    h_s = dst_h / src_h
    w_s = dst_w / src_w
    return w_s, h_s, dst_w / 2.0 - w_s * src_w / 2.0, dst_h / 2.0 - h_s * src_h / 2.0


def affine_warp_inverse(
    image: torch.Tensor,
    inv_coeffs: tuple[float, float, float, float],
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Inverse-map bilinear affine warp with zero border (cv2.warpAffine semantics); HWC.

    ``inv_coeffs = (a_x, a_y, b_x, b_y)`` maps destination pixel (x, y) to the
    source coordinate (a_x*x + b_x, a_y*y + b_y). Separable: the two row taps
    are gathered and blended, then the two column taps; a tap outside the
    source contributes zero (cv2.BORDER_CONSTANT, the reference default).
    The JAX arithmetic, in f32.
    """
    a_x, a_y, b_x, b_y = inv_coeffs
    src_h, src_w = image.shape[0], image.shape[1]
    dev = image.device
    src_x = torch.arange(out_w, dtype=torch.float32, device=dev) * a_x + b_x
    src_y = torch.arange(out_h, dtype=torch.float32, device=dev) * a_y + b_y
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = src_x - x0, src_y - y0  # lerp weights toward x0 + 1, y0 + 1
    x0i, y0i = x0.long(), y0.long()

    def gather(img: torch.Tensor, idx: torch.Tensor, axis: int, size: int) -> torch.Tensor:
        valid = ((idx >= 0) & (idx <= size - 1)).to(img.dtype)
        taken = img.index_select(axis, idx.clamp(0, size - 1))
        shape = [1] * img.dim()
        shape[axis] = idx.shape[0]
        return taken * valid.reshape(shape)

    img = image.float()
    wy_col = wy.reshape(-1, *([1] * (img.dim() - 1)))
    rows = gather(img, y0i, 0, src_h) * (1.0 - wy_col) + gather(img, y0i + 1, 0, src_h) * wy_col
    wx_row = wx.reshape(1, -1, *([1] * (img.dim() - 2)))
    return gather(rows, x0i, 1, src_w) * (1.0 - wx_row) + gather(rows, x0i + 1, 1, src_w) * wx_row


def affine_rescale(image: torch.Tensor, target_height: int, target_width: int) -> torch.Tensor:
    """Centered anisotropic affine rescale of one HWC image, the reference ``rescale``
    (dataset.py:36-52: a forward scale-about-centre affine through cv2.warpAffine,
    bilinear, zero border), applied here as its exact inverse map."""
    src_h, src_w = image.shape[0], image.shape[1]
    w_s, h_s, tx, ty = _affine_rescale_matrix(src_h, src_w, target_height, target_width)
    # dst = s * src + t  =>  src = (dst - t) / s
    return affine_warp_inverse(image, (1.0 / w_s, 1.0 / h_s, -tx / w_s, -ty / h_s),
                               target_height, target_width)

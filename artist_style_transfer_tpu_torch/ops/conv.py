"""Convolution, dense and pooling primitives with ``torch.nn`` semantics.

Counterpart of the JAX ``ops/conv.py`` in behaviour only: tensors are NCHW
(``channels_last`` memory), weights torch-native — OIHW for convs,
(I, O, kH, kW) for transpose convs, unflipped, and (O, I) for dense layers.
Every product follows the port's precision policy (``ops/precision.py``),
which sets cuBLAS's and cuDNN's TF32 flags: off in parity mode. The TPU shape rewrites of the
JAX module (the dx/cin-factored stems, the W-reflect/H-zero fold conv, the
small-C_in frozen conv and the fused relu/pool ops) compute the same math
and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.ops.pad import reflect_pad_hw


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """2-D convolution with symmetric zero padding, matching ``nn.Conv2d``."""
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: int = 2,
    padding: int = 1,
    output_padding: int = 1,
) -> torch.Tensor:
    """Transposed convolution matching ``nn.ConvTranspose2d``.

    Output size ``(H-1)*s - 2p + k + op``: k3 s2 p1 op1 is an exact x2
    upsample, k1 s1 p0 op0 a 1x1 conv (reference cnn.py:108).
    """
    return F.conv_transpose2d(
        x, w, b, stride=stride, padding=padding, output_padding=output_padding
    )


def conv2d_reflect(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 1
) -> torch.Tensor:
    """Reflect-pad by ``k // 2``, then a valid conv (reference ConvLayer, cnn.py:55-63)."""
    return conv2d(reflect_pad_hw(x, w.shape[-1] // 2), w, b, stride=stride, padding=0)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Dense layer ``x @ w.T + b`` on (N, I) with an (O, I) weight, as ``nn.Linear``."""
    return F.linear(x, w, b)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2, padding: int = 0) -> torch.Tensor:
    """Max pooling as ``nn.MaxPool2d(window, stride, padding)``: the border counts as -inf."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NCHW -> NC (``AdaptiveAvgPool2d(1)`` + flatten), any memory format."""
    return x.mean(dim=(2, 3))


def max_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Global max pool NCHW -> NC (``AdaptiveMaxPool2d(1)`` + flatten), any memory format."""
    return x.amax(dim=(2, 3))

"""Instance norm forward (counterpart of the JAX ``ops/norm.py:17-64``).

The hand-derived backward of the JAX module (``norm.py:67-145``) belongs
to the training slice; the stylize path runs the forward under
``no_grad``.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.ops.precision import get_precision

# torch nn.InstanceNorm2d default epsilon (parity-critical).
INSTANCE_NORM_EPS = 1e-5


def instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = INSTANCE_NORM_EPS,
) -> torch.Tensor:
    """Affine instance norm over an NCHW tensor, stats over (H, W) in f32.

    Biased variance, as ``nn.InstanceNorm2d(C, affine=True)``. The variance
    follows the precision policy as in JAX: the two-pass E[(x-mean)^2]
    under ``"highest"``, the one-pass E[x^2] - mean^2 otherwise.
    """
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    if get_precision() == "highest":
        var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
        var = (m2 - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    y = ((x32 - mean) * inv).to(x.dtype)
    return y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)

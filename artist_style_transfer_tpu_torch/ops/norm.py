"""Instance norm with a hand-derived backward, and batch norm, frozen or in train mode
(counterpart of the JAX ``ops/norm.py``).

Both instance-norm functions are one ``torch.autograd.Function``: the forward keeps ``x``
(already resident) and the (N, C, 1, 1) f32 statistics (f64 for f64 input), and the backward
recomputes x-hat from them instead of letting autograd save the f32
``x - mean`` of every layer. ``instance_norm_act`` folds the following ReLU
in and recomputes its mask in the backward from x-hat*gamma + beta > 0, so
no mask is stored either. The JAX package tried a Pallas IN backward on the
TPU, measured it slower and removed it (``norm.py:109-113``): this is the
XLA form, in plain PyTorch, with no kernel.

Tensors are NCHW (``channels_last`` memory in the port); dx comes back in
the memory format of x, so cuDNN's dgrad after it needs no layout copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from artist_style_transfer_tpu_torch.ops.precision import get_precision

# torch nn.InstanceNorm2d and nn.BatchNorm{1,2}d default epsilon (parity-critical).
INSTANCE_NORM_EPS = 1e-5
BATCH_NORM_EPS = 1e-5


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32 and narrower inputs (as JAX); f64 stays f64, for gradcheck."""
    return torch.promote_types(x.dtype, torch.float32)


def _in_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Forward of JAX ``_in_forward``: (y, mean, inv) with f32 stats over (H, W).

    The variance follows the precision policy as in JAX: the two-pass
    E[(x-mean)^2] under ``"highest"``, the one-pass E[x^2] - mean^2 otherwise.
    """
    x32 = x.to(_stats_dtype(x))
    mean = x32.mean(dim=(2, 3), keepdim=True)
    if get_precision() == "highest":
        var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    else:
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
        var = (m2 - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    y = ((x32 - mean) * inv).to(x.dtype) * _channels(scale) + _channels(bias)
    return y, mean, inv


class _InstanceNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, relu: bool, eps: float):
        y, mean, inv = _in_forward(x, scale, bias, eps)
        ctx.save_for_backward(x, mean, inv, scale, bias)
        ctx.relu = relu
        return torch.relu(y) if relu else y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        """dx = inv * (g - mean(g) - xhat * mean(g * xhat)), g = dy * gamma;
        dgamma = sum(dy * xhat), dbeta = sum(dy); every reduction in f32
        (JAX ``_in_bwd`` and ``_in_act_bwd_xla``)."""
        x, mean, inv, scale, bias = ctx.saved_tensors
        acc = mean.dtype
        xhat = (x.to(acc) - mean) * inv
        dya = dy.to(acc)
        if ctx.relu:
            pre = xhat * _channels(scale.to(acc)) + _channels(bias.to(acc))
            dya = torch.where(pre > 0, dya, 0.0)
        dgamma = (dya * xhat).sum(dim=(0, 2, 3)).to(scale.dtype)
        dbeta = dya.sum(dim=(0, 2, 3)).to(bias.dtype)
        g = dya * _channels(scale.to(acc))
        m1 = g.mean(dim=(2, 3), keepdim=True)
        m2 = (g * xhat).mean(dim=(2, 3), keepdim=True)
        dx = (inv * (g - m1 - xhat * m2)).to(x.dtype)
        return dx.contiguous(memory_format=_memory_format(x)), dgamma, dbeta, None, None


def instance_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = INSTANCE_NORM_EPS,
) -> torch.Tensor:
    """Affine instance norm over an NCHW tensor, stats over (H, W) in f32.

    Biased variance, as ``nn.InstanceNorm2d(C, affine=True)``; differentiable
    through the hand-derived backward.
    """
    return _InstanceNormFunction.apply(x, scale, bias, False, eps)


def instance_norm_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = True,
    eps: float = INSTANCE_NORM_EPS,
) -> torch.Tensor:
    """``relu(instance_norm(x, scale, bias))`` (or plain IN with ``relu=False``)
    as one function, whose backward recomputes the ReLU mask; the
    TransformerNet runs every norm through it."""
    return _InstanceNormFunction.apply(x, scale, bias, relu, eps)


def batch_norm_inference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = BATCH_NORM_EPS,
) -> torch.Tensor:
    """Batch norm on frozen running statistics: ``x * inv + (beta - mean * inv)``.

    The reference runs its ResNet-50 classifier in ``eval()`` only
    (train_cnn.py:158, inference.py:62); training the classifier itself uses
    :func:`batch_norm_train`. Works on NCHW (any memory format; the output keeps
    x's) and on NC; computed in x's dtype, as JAX's. Plain autograd gives the data
    gradient.
    """
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(running_var + eps) * scale
    return x * inv.view(shape) + (bias - running_mean * inv).view(shape)


class _GlobalBatchNormFunction(torch.autograd.Function):
    """Train-mode batch norm over a batch split across ``mesh``'s ranks: the statistics
    are the whole batch's, as GSPMD makes them when it turns JAX's reductions into
    all-reduces. Forward: the per-channel sums and counts, then the centred squares,
    each all-reduced; backward: the two per-channel sums the input gradient needs,
    all-reduced in one call. ``scale`` and ``bias`` get this rank's part of their
    gradient, which the trainer's gradient all-reduce completes."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, mesh):
        acc = _stats_dtype(x)
        dims = (0,) + tuple(range(2, x.dim()))
        x32 = x.to(acc)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        s = torch.cat([x32.sum(dims), x32.new_full((1,), x32.numel() / x.shape[1])])
        mesh.all_reduce_(s)
        n = s[-1]
        mean = s[:-1] / n
        xc = x32 - mean.view(shape)
        sq = mesh.all_reduce_(xc.square().sum(dims))
        var = sq / n
        inv = torch.rsqrt(var + eps)
        xhat = xc * inv.view(shape)
        y = (xhat * scale.to(acc).view(shape) + bias.to(acc).view(shape)).to(x.dtype)
        unbiased = sq / (n - 1).clamp_min(1.0)
        ctx.save_for_backward(xhat, inv, scale)
        ctx.mesh, ctx.n, ctx.dtypes = mesh, n, (x.dtype, scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(mean, unbiased)
        return y.contiguous(memory_format=_memory_format(x)), mean, unbiased

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        xhat, inv, scale = ctx.saved_tensors
        x_dtype, s_dtype, b_dtype = ctx.dtypes
        dims = (0,) + tuple(range(2, xhat.dim()))
        shape = (1, -1) + (1,) * (xhat.dim() - 2)
        dya = dy.to(xhat.dtype)
        local = torch.stack([dya.sum(dims), (dya * xhat).sum(dims)])
        dbeta, dgamma = local[0].clone(), local[1].clone()  # this rank's part
        g = ctx.mesh.all_reduce_(local) / ctx.n
        dx = (scale.to(xhat.dtype) * inv).view(shape) * (
            dya - g[0].view(shape) - xhat * g[1].view(shape))
        return (dx.to(x_dtype).contiguous(memory_format=_memory_format(dy)),
                dgamma.to(s_dtype), dbeta.to(b_dtype), None, None)


def batch_norm_train(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = BATCH_NORM_EPS,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode batch norm (JAX ``batch_norm_train``): ``(y, batch_mean,
    batch_var_unbiased)``.

    Normalizes by the batch statistics over every axis but the channel axis 1
    (NCHW in any memory format, or NC) with the biased variance, and returns the
    unbiased one: the pair ``nn.BatchNorm{1,2}d`` uses in train mode. One
    ``F.batch_norm`` call (cuDNN's fused kernels on the card) computes both: its
    running buffers start at 0 and take momentum 1, so they come back holding the
    batch's statistics, in f32 (f64 for f64 input). Differentiable in ``x``,
    ``scale`` and ``bias``; the statistics carry no gradient.

    With ``mesh`` (a :class:`parallel.mesh.Mesh` whose ranks hold one batch between
    them) the statistics are the whole batch's (JAX ``ops/norm.py:170-197`` under
    GSPMD), from one autograd function that all-reduces its sums forward and
    backward; ``nn.SyncBatchNorm`` needs CUDA, and the port's tests run on the CPU.
    """
    if mesh is not None:
        return _GlobalBatchNormFunction.apply(x, scale, bias, eps, mesh)
    mean, var = torch.zeros((2, x.shape[1]), dtype=_stats_dtype(x), device=x.device)
    y = F.batch_norm(x, mean, var, scale, bias, training=True, momentum=1.0, eps=eps)
    return y, mean, var

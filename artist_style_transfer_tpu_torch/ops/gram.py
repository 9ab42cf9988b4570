"""Batched Gram matrices — the style-loss hot op (counterpart of the JAX ``ops/gram.py``).

``gram(f) = f^T f / (C*H*W)`` over the flattened spatial axis of NHWC
features. On a CUDA tensor the forward is the hand-written Hopper kernel
(:mod:`artist_style_transfer_tpu_torch.ops.cuda.gram_kernel`); the backward
is one batched matmul, as in JAX, where the VJP also runs outside Pallas.
The int8 Gram of the JAX module belongs to the int8 slice.
"""

from __future__ import annotations

import torch


def gram_matrix_plain(features_nhwc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Gram with the semantics of JAX ``gram_matrix_xla``: (N, C, C) f32."""
    n, h, w, c = features_nhwc.shape
    f = features_nhwc.reshape(n, h * w, c).float()
    return torch.bmm(f.transpose(1, 2), f) / float(c * h * w)


def resolve_use_kernel(t: torch.Tensor, use_kernel: str | bool) -> bool:
    """``"auto"`` -> the kernel on a CUDA tensor, the plain version on a CPU one.

    ``True`` on a CPU tensor raises; ``False`` is an explicit caller choice
    (tests and the kernel-vs-plain comparison of ``chip_smoke.py``).
    """
    if use_kernel == "auto":
        return t.is_cuda
    if use_kernel is True and not t.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the Gram kernel has no CPU form")
    if use_kernel not in (True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
    return use_kernel


class GramFunction(torch.autograd.Function):
    """Differentiable Gram: forward by the kernel (or the plain version when
    ``use_kernel`` is False), backward dF = F (dG + dG^T) / (C*H*W)."""

    @staticmethod
    def forward(ctx, features_nhwc: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        ctx.save_for_backward(features_nhwc)
        if use_kernel:
            from artist_style_transfer_tpu_torch.ops.cuda.gram_kernel import gram_matrix_cuda

            return gram_matrix_cuda(features_nhwc)
        return gram_matrix_plain(features_nhwc)

    @staticmethod
    def backward(ctx, dg: torch.Tensor):
        (f,) = ctx.saved_tensors
        n, h, w, c = f.shape
        scale = 1.0 / float(c * h * w)
        # Only the tiny (N, C, C) cotangent is symmetrized and cast; F keeps its dtype.
        sym = ((dg.float() + dg.float().transpose(1, 2)) * scale).to(f.dtype)
        df = torch.bmm(f.reshape(n, h * w, c), sym)
        return df.reshape(n, h, w, c), None


def gram_matrix(features_nhwc: torch.Tensor, use_kernel: str | bool = "auto") -> torch.Tensor:
    """Normalized Gram (N, C, C) f32 of NHWC features, differentiable.

    Unlike JAX, where ``"auto"`` picked the Pallas kernel only for
    TPU-tileable shapes, the Hopper kernel takes every shape, so ``"auto"``
    means the kernel on every CUDA tensor (see :func:`resolve_use_kernel`).
    """
    return GramFunction.apply(features_nhwc, resolve_use_kernel(features_nhwc, use_kernel))

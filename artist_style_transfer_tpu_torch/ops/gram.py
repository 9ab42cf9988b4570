"""Batched Gram matrices — the style-loss hot op (counterpart of the JAX ``ops/gram.py``).

``gram(f) = f^T f / (C*H*W)`` over the flattened spatial axis of NHWC
features. On a CUDA tensor the forward is the hand-written Hopper kernel
(:mod:`artist_style_transfer_tpu_torch.ops.cuda.gram_kernel`); the backward
is one batched matmul, as in JAX, where the VJP also runs outside Pallas.

:func:`gram_matrix_int8` is the int8 Gram of the quantized training loss (JAX
``gram_matrix_int8``): the features quantized with a dynamic per-tensor scale,
``G = Fq^T Fq * s_f^2 / (C*H*W)``, and its STE backward, a second int8 product
of the codes with the quantized, symmetrized cotangent. Both are plain int8 x
int8 -> int32 matrix products, which the JAX package runs as XLA
``dot_general``s outside any Pallas kernel. On CUDA they run on
``torch._int_mm`` (cuBLASLt), one call an image, whose int32 sum is exact, as
JAX's is; no hand kernel is written for them, as the roadmap asks for one only
where a profile of the card does. On the CPU the plain version holds the codes in
f64 (the sums reach HW * 127^2, past f32's 2^24, and f64 holds them exactly).
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.ops.qconv import absmax_scale, quant_i8

INT_MM_CALLS = 0  # torch._int_mm calls of the int8 Gram, forward and backward


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


def _int_mm_rows(hw: int) -> int:
    """Rows of the zero-padded codes: ``torch._int_mm`` takes K a multiple of 8 (the
    forward's HW) and M above 16 (the backward's HW); zero rows add nothing."""
    return max(24, -(-hw // 8) * 8)


def int8_products(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The exact int32 products ``a[n] @ b_t[n]^T`` of int8 ``a`` (N, M, K) and ``b_t``
    (N, P, K): (N, M, P).

    On CUDA one ``torch._int_mm`` an image, its left operand row-major and its right
    one column-major (the layout cuBLASLt's int8 GEMM takes); on the CPU the plain
    version, the codes in f64.
    """
    global INT_MM_CALLS
    if not a.is_cuda:
        return torch.bmm(a.double(), b_t.double().transpose(1, 2)).round().to(torch.int32)
    a, b_t = a.contiguous(), b_t.contiguous()
    out = torch.empty((a.shape[0], a.shape[1], b_t.shape[1]), dtype=torch.int32, device=a.device)
    for n in range(a.shape[0]):
        torch._int_mm(a[n], b_t[n].t(), out=out[n])
        INT_MM_CALLS += 1
    return out


class GramInt8Function(torch.autograd.Function):
    """The int8 Gram and its STE backward (JAX ``_gram_int8_fwd`` / ``_gram_int8_bwd``)."""

    @staticmethod
    def forward(ctx, features_nhwc: torch.Tensor, mesh) -> torch.Tensor:
        n, h, w, c = features_nhwc.shape
        s_f = absmax_scale(features_nhwc, mesh)
        fq = features_nhwc.new_zeros((n, _int_mm_rows(h * w), c), dtype=torch.int8)
        fq[:, : h * w] = quant_i8(features_nhwc, s_f).reshape(n, h * w, c)
        ctx.save_for_backward(fq, s_f)
        ctx.meta = (features_nhwc.shape, features_nhwc.dtype)
        ctx.mesh = mesh
        fq_t = fq.transpose(1, 2).contiguous()  # (N, C, HW): Fq^T row-major
        acc = int8_products(fq_t, fq_t)
        return acc.float() * (s_f * s_f / float(c * h * w))

    @staticmethod
    def backward(ctx, dg: torch.Tensor):
        fq, s_f = ctx.saved_tensors
        (n, h, w, c), dtype = ctx.meta
        sym = (dg.float() + dg.float().transpose(1, 2)) * (1.0 / float(c * h * w))
        s_sym = absmax_scale(sym, ctx.mesh)
        sym_t = quant_i8(sym, s_sym).transpose(1, 2)  # b[n] = symq[n], handed over transposed
        acc = int8_products(fq, sym_t)[:, : h * w]
        df = acc.float() * (s_f * s_sym)
        return df.reshape(n, h, w, c).to(dtype), None


def gram_matrix_int8(features_nhwc: torch.Tensor, mesh=None) -> torch.Tensor:
    """Normalized Gram (N, C, C) f32 of NHWC features in int8, differentiable (STE).
    With ``mesh`` both dynamic scales are the whole batch's over its ranks
    (:func:`ops.qconv.absmax_scale`)."""
    return GramInt8Function.apply(features_nhwc, mesh)

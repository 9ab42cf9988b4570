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
:func:`gram_matrix_int8_rows` is the same Gram from bands of an image's rows: each
band's int32 products, summed over the ranks in int32, equal the one process's
exactly, given the same codes.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.ops.qconv import absmax_scale, quant_i8
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    int_sum_over_ranks,
    sum_over_ranks,
    zeros_from,
)

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


def gram_matrix_rows(band_nhwc: torch.Tensor, bands, use_kernel: str | bool = "auto"
                     ) -> torch.Tensor:
    """The whole image's normalized Gram (N, C, C) f32 from this rank's band of rows
    (``bands``, a :class:`parallel.spatial.RowBands`, says whose band is which): the
    band's Gram by :func:`gram_matrix` (kernel K1 on a CUDA tensor), normalized by
    C·h·W, scaled by h/H and summed over the ranks, the same on every rank.
    Differentiable: the sum's backward is the identity (every rank's loss holds the
    whole Gram), the band's is :class:`GramFunction`'s. An empty band adds zeros and
    launches nothing."""
    n, h, w, c = band_nhwc.shape
    if h == 0:
        g = zeros_from(band_nhwc, (n, c, c), torch.float32)
    else:
        g = gram_matrix(band_nhwc, use_kernel) * (h / bands.height)
    return sum_over_ranks(g, bands.mesh, replicated=True)


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
    """The int8 Gram and its STE backward (JAX ``_gram_int8_fwd`` / ``_gram_int8_bwd``)
    from this rank's band of rows (the whole image where ``bands`` has one rank):
    ``s_f`` the max over ``mesh`` (every rank that holds part of the batch), each band's
    int32 products summed over the 'space' ranks (``bands.mesh``) in int32, then scaled
    with the global H. The backward takes the whole Gram's cotangent (every rank's loss
    holds the whole Gram) and gives the band's dF = s_f·s_sym·Fq_band·quant(sym),
    ``s_sym`` the max over ``mesh``. An empty band launches nothing and joins every
    collective."""

    @staticmethod
    def forward(ctx, band_nhwc: torch.Tensor, bands, mesh) -> torch.Tensor:
        n, h, w, c = band_nhwc.shape
        s_f = absmax_scale(band_nhwc, mesh)
        fq = band_nhwc.new_zeros((n, _int_mm_rows(h * w), c), dtype=torch.int8)
        if h:
            fq[:, : h * w] = quant_i8(band_nhwc, s_f).reshape(n, h * w, c)
            fq_t = fq.transpose(1, 2).contiguous()  # (N, C, HW): Fq^T row-major
            acc = int8_products(fq_t, fq_t)
        else:
            acc = band_nhwc.new_zeros((n, c, c), dtype=torch.int32)
        acc = int_sum_over_ranks(acc, bands.mesh)
        ctx.save_for_backward(fq, s_f)
        ctx.meta = (band_nhwc.shape, band_nhwc.dtype, bands.height)
        ctx.mesh = mesh
        return acc.float() * (s_f * s_f / float(c * bands.height * w))

    @staticmethod
    def backward(ctx, dg: torch.Tensor):
        fq, s_f = ctx.saved_tensors
        (n, h, w, c), dtype, height = ctx.meta
        sym = (dg.float() + dg.float().transpose(1, 2)) * (1.0 / float(c * height * w))
        s_sym = absmax_scale(sym, ctx.mesh)
        if not h:
            return dg.new_zeros((n, 0, w, c), dtype=dtype), None, None
        sym_t = quant_i8(sym, s_sym).transpose(1, 2)
        acc = int8_products(fq, sym_t)[:, : h * w]
        df = acc.float() * (s_f * s_sym)
        return df.reshape(n, h, w, c).to(dtype), None, None


def gram_matrix_int8_rows(band_nhwc: torch.Tensor, bands, mesh=None) -> torch.Tensor:
    """The whole image's int8 Gram (N, C, C) f32 from this rank's band of rows (``bands``,
    a :class:`parallel.spatial.RowBands`), the same on every rank of ``bands.mesh``;
    differentiable (STE, :class:`GramInt8Function`). ``mesh``: the ranks that hold
    the batch between them (data and 'space'), for the dynamic scales; None means
    ``bands.mesh``."""
    return GramInt8Function.apply(band_nhwc, bands, bands.mesh if mesh is None else mesh)


def gram_matrix_int8(features_nhwc: torch.Tensor, mesh=None) -> torch.Tensor:
    """Normalized Gram (N, C, C) f32 of NHWC features in int8, differentiable (STE): the
    banded Gram of one band, the whole image. With ``mesh`` both dynamic scales are the
    whole batch's over its ranks (:func:`ops.qconv.absmax_scale`)."""
    whole = RowBands.split(Mesh(None, ("space",), (1,), 0, features_nhwc.device, None),
                           features_nhwc.shape[1])
    return GramInt8Function.apply(features_nhwc, whole, mesh)

"""Int8 convolution with exact int32 accumulation (counterpart of the forward half of
the JAX ``ops/qconv.py``).

Symmetric round-to-nearest quantization, with the JAX arithmetic so that both
packages give the same codes (``torch.round`` and ``jnp.round`` both round half
to even):

- weights: per-output-channel int8, ``round(w / sw)`` with ``sw = absmax / 127``
  (:func:`quant_weight`);
- activations: per-tensor, ``round(x * (1 / s))`` (:func:`quant_i8`), with a
  static scale (the TransformerNet) or a dynamic one, the absmax of each call
  (:func:`absmax_scale`, the ResNet-50 classifier).

:func:`conv_i8` convolves int8 codes into the exact int32 sum and sends a CUDA
tensor to the hand-written Hopper kernel K2
(:mod:`artist_style_transfer_tpu_torch.ops.cuda.qconv_kernel`: an implicit GEMM
on the s8 warpgroup MMA, ``wgmma``, with the lhs-dilated convs split into their
sub-pixel classes), a CPU tensor to the plain version beside it,
:func:`conv_i8_plain`. Its ``out`` picks the
epilogue: the int32 sum, its bf16 rounding (JAX ``accum=bfloat16``), or the
dequantized ``acc * (s_in * sw) + b`` (:class:`Dequant`). The absmax and the
quantize stay torch ops, as JAX runs them in XLA outside any kernel.

Tensors are NCHW in the ``channels_last`` memory format, the port's layout:
int8 activations are NHWC in memory and weights (C_out, kh, kw, C_in).

The STE backward of :func:`conv2d_frozen_int8` (K2's data gradient) belongs
to ROADMAP Queue 1 item 10b; until then reaching for its gradient raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

PAD_MODES = ("zeros", "reflect")
_ITEM_10B = ("the int8 data gradient (the STE backward of conv2d_frozen_int8) comes with "
            "the port's int8 loss slice (ROADMAP Queue 1 item 10b)")


class Dequant(NamedTuple):
    """The dequant epilogue: ``acc * (s_in * sw[c]) + bias[c]`` in f32, stored as ``dtype``."""

    s_in: torch.Tensor  # () f32, the activation scale (on the device: no host sync)
    sw: torch.Tensor  # (C_out,) f32, the weight scales
    bias: torch.Tensor | None  # (C_out,) f32
    dtype: torch.dtype  # torch.float32 or torch.bfloat16


def absmax_scale(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 scale: absmax / 127 (f32 scalar, never 0)."""
    return t.float().abs().amax().clamp_min(1e-30) / 127.0


def quant_i8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(t / scale) clipped to [-127, 127] as int8, computed as JAX does:
    ``round(t.float() * (1 / scale))`` with an f32 scalar ``scale``. Keeps t's
    memory format."""
    q = torch.round(t.float() * (1.0 / scale.float()))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def quant_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weight quantization of an OIHW weight.

    Returns ``(wq, sw)``: int8 OIHW in ``channels_last`` (the kernel's
    (C_out, kh, kw, C_in)) and f32 (C_out,), with ``wq * sw ~= w``.
    """
    w32 = w.float()
    sw = w32.abs().amax(dim=(1, 2, 3)).clamp_min(1e-30) / 127.0
    wq = torch.round(w32 / sw.view(-1, 1, 1, 1)).clamp_(-127.0, 127.0).to(torch.int8)
    return wq.contiguous(memory_format=torch.channels_last), sw


def _pads(padding: int | tuple[int, int]) -> tuple[int, int]:
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    if lo < 0 or hi < 0:
        raise ValueError(f"conv_i8 pads must be >= 0, got {(lo, hi)}")
    return lo, hi


def conv_out_size(size: int, k: int, stride: int, lo: int, hi: int, dilation: int) -> int:
    """Output extent of a conv over the lhs-dilated, padded input."""
    return ((size - 1) * dilation + 1 + lo + hi - k) // stride + 1


def _check(xq: torch.Tensor, wq: torch.Tensor, stride: int, lo: int, hi: int, dilation: int,
           pad_mode: str) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"conv_i8 takes int8 codes, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"conv_i8 takes NCHW x and OIHW w with one C_in, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode must be one of {PAD_MODES}, got {pad_mode!r}")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride and lhs_dilation must be >= 1, got {stride}, {dilation}")
    if pad_mode == "reflect":
        if dilation != 1:
            raise ValueError("reflect padding of an lhs-dilated input is not a conv of the slice")
        if max(lo, hi) >= min(xq.shape[2], xq.shape[3]):
            raise ValueError(f"reflect pads {(lo, hi)} must be under the size {tuple(xq.shape[2:])}")
    for size, k in ((xq.shape[2], wq.shape[2]), (xq.shape[3], wq.shape[3])):
        if conv_out_size(size, k, stride, lo, hi, dilation) < 1:
            raise ValueError(f"conv_i8: kernel {tuple(wq.shape[2:])} over an empty window")


def apply_epilogue(acc: torch.Tensor, out: torch.dtype | Dequant) -> torch.Tensor:
    """The three epilogues on the exact int32 sum, in the kernel's order of operations."""
    if out == torch.int32:
        return acc
    if out == torch.bfloat16:
        return acc.float().to(torch.bfloat16)  # int32 -> f32 -> bf16, each to nearest even
    if not isinstance(out, Dequant):
        raise ValueError(f"out must be torch.int32, torch.bfloat16 or a Dequant, got {out!r}")
    y = acc.float() * (out.s_in.float() * out.sw.float()).view(1, -1, 1, 1)
    if out.bias is not None:
        y = y + out.bias.float().view(1, -1, 1, 1)
    return y.to(out.dtype)


def conv_i8_plain(
    xq: torch.Tensor,
    wq: torch.Tensor,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    lhs_dilation: int = 1,
    pad_mode: str = "zeros",
    out: torch.dtype | Dequant = torch.int32,
) -> torch.Tensor:
    """The plain version of K2: the codes held in float64 and convolved in f64.

    Every product is at most 127^2 and every sum stays far below 2^53, so the
    f64 result is the exact integer sum (rounded once more in case the conv
    algorithm is not exact, as an FFT one would not be); an f32 conv is not
    exact (127^2 * 4608 > 2^24). Used on the CPU, and as K2's oracle on the card.
    """
    lo, hi = _pads(padding)
    _check(xq, wq, stride, lo, hi, lhs_dilation, pad_mode)
    x = xq.double()
    if lhs_dilation > 1:
        n, c, h, w = x.shape
        d = lhs_dilation
        xd = x.new_zeros((n, c, (h - 1) * d + 1, (w - 1) * d + 1))
        xd[:, :, ::d, ::d] = x
        x = xd
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect" if pad_mode == "reflect" else "constant")
    acc = torch.round(F.conv2d(x, wq.double(), stride=stride)).to(torch.int32)
    return apply_epilogue(acc.contiguous(memory_format=torch.channels_last), out)


def conv_i8(
    xq: torch.Tensor,
    wq: torch.Tensor,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    lhs_dilation: int = 1,
    pad_mode: str = "zeros",
    out: torch.dtype | Dequant = torch.int32,
) -> torch.Tensor:
    """int8 x int8 -> exact int32 convolution, then the ``out`` epilogue.

    ``xq`` NCHW int8, ``wq`` OIHW int8 (both ``channels_last`` in memory);
    ``padding`` is ``(lo, hi)`` on both spatial axes (an int: symmetric), zero
    or reflect (``pad_mode``), applied after the zero-insert ``lhs_dilation``
    (the transpose-conv form). A CUDA tensor goes to kernel K2, which takes
    C_in a multiple of 32 and raises otherwise; a CPU tensor goes to
    :func:`conv_i8_plain`. Nothing falls back from one to the other.
    """
    lo, hi = _pads(padding)
    if xq.is_cuda:  # K2 makes the other checks once a shape, with its plan
        if pad_mode not in PAD_MODES:
            raise ValueError(f"pad_mode must be one of {PAD_MODES}, got {pad_mode!r}")
        from artist_style_transfer_tpu_torch.ops.cuda.qconv_kernel import conv_i8_cuda

        return conv_i8_cuda(xq, wq, stride, lo, hi, lhs_dilation, pad_mode == "reflect", out)
    _check(xq, wq, stride, lo, hi, lhs_dilation, pad_mode)
    if wq.is_cuda:
        raise ValueError("conv_i8: x is on the CPU and w on CUDA")
    return conv_i8_plain(xq, wq, stride, (lo, hi), lhs_dilation, pad_mode, out)


def conv2d_frozen_int8(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: torch.Tensor | None,
    padding: int = 1,
    stride: int = 1,
) -> torch.Tensor:
    """Zero-padded conv of a FROZEN layer in int8 (forward of JAX ``conv2d_frozen_int8``).

    ``dequant(conv(quant(x), wq)) + b`` with a dynamic per-tensor input scale:
    ``acc * (s_in * sw) + b`` in f32, cast to ``x.dtype``. Forward only: on an
    input that requires grad it raises ``NotImplementedError`` (the STE data
    gradient is ROADMAP item 10b); it never falls back to a real-dtype conv.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(_ITEM_10B)
    s_in = absmax_scale(x)
    return conv_i8(quant_i8(x, s_in), wq, stride, padding,
                   out=Dequant(s_in, sw, b, x.dtype))

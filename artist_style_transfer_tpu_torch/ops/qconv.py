"""Int8 convolution with exact int32 accumulation (counterpart of the forward half of
the JAX ``ops/qconv.py``).

Symmetric round-to-nearest quantization, with the JAX arithmetic so that both
packages give the same codes (``torch.round`` and ``jnp.round`` both round half
to even):

- weights: per-output-channel int8, ``round(w / sw)`` with ``sw = absmax / 127``
  (:func:`quant_weight`);
- activations: per-tensor, ``round(x * (1 / s))`` (:func:`quant_i8`), with a
  static scale (the TransformerNet) or a dynamic one, the absmax of each call
  (:func:`absmax_scale`, the ResNet-50 classifier). Where ranks hold one batch
  between them (data-parallel training, sharded evaluation) the caller passes
  their ``mesh`` and the absmax is the whole batch's, as GSPMD gives JAX's
  per-tensor absmax of a batch-sharded array.

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

Two differentiable convs, each one ``torch.autograd.Function`` with the
straight-through estimator (STE) of JAX's custom VJPs, which passes the
cotangent through the rounding and the clip unchanged:

- :func:`conv2d_frozen_int8` for a frozen layer (the VGG16 loss extractor, the
  quantized classifier): no weight or bias gradient;
- :func:`conv2d_qat_int8` for a trained layer (the QAT TransformerNet): the
  weight and bias gradients are real-dtype, of the dequantized forward, the
  weight's on cuDNN.

Both compute the data gradient as a second int8 conv on the same codes: the
per-output-channel weight scales fold into the cotangent (exact: they factor
out of the C_out contraction), which is quantized with a dynamic scale and
convolved with the flipped, transposed codes (:func:`_dgrad`). A strided
forward's dgrad is lhs-dilated by the stride with the pads of
:func:`_dgrad_pad`; an lhs-dilated forward's dgrad has the dilation as its
window stride. On CUDA both convs are K2's. Each takes the caller's ``mesh`` at
its forward and keeps it for its backward's dynamic scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

PAD_MODES = ("zeros", "reflect")


class Dequant(NamedTuple):
    """The dequant epilogue: ``acc * (s_in * sw[c]) + bias[c]`` in f32, stored as ``dtype``."""

    s_in: torch.Tensor  # () f32, the activation scale (on the device: no host sync)
    sw: torch.Tensor  # (C_out,) f32, the weight scales
    bias: torch.Tensor | None  # (C_out,) f32
    dtype: torch.dtype  # torch.float32 or torch.bfloat16


def absmax_scale(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-tensor symmetric int8 scale: absmax / 127 (f32 scalar, never 0), a constant
    to autograd. With ``mesh`` (a :class:`parallel.mesh.Mesh` whose ranks each hold a
    slice of one batch: a band of its rows too, over a 'space' axis) the absmax is the
    max over its ranks: the whole batch's. An empty slice adds 0 and still joins."""
    t = t.detach()
    amax = t.float().abs().amax() if t.numel() else t.new_zeros((), dtype=torch.float32)
    if mesh is not None:
        mesh.all_reduce_(amax, "max")
    return amax.clamp_min(1e-30) / 127.0


def quant_i8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(t / scale) clipped to [-127, 127] as int8, computed as JAX does:
    ``round(t.float() * (1 / scale))`` with an f32 scalar ``scale``. Keeps t's
    memory format."""
    return quant_i8_inv(t, 1.0 / scale.float())


def quant_i8_inv(t: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """:func:`quant_i8` with the reciprocal of its scale already taken: ``inv_scale`` is
    ``1.0 / scale.float()``, an f32 scalar."""
    q = torch.round(t.float() * inv_scale)
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


def _dgrad_pad(i_size: int, o_size: int, k: int, stride: int, lhs_d: int,
               lo: int) -> tuple[int, int]:
    """Pads (lo, hi) of the data-gradient conv of a forward conv with window ``stride``,
    low pad ``lo`` and lhs dilation ``lhs_d`` that maps ``i_size`` inputs to ``o_size``
    outputs (JAX ``ops/qconv.py:_dgrad_pad``).

    The dgrad runs over dy lhs-dilated by ``stride``, with window stride ``lhs_d``;
    its high pad is solved so that it gives exactly ``i_size`` outputs.
    """
    p_lo = k - 1 - lo
    dil_o = stride * (o_size - 1) + 1
    p_hi = lhs_d * (i_size - 1) + k - dil_o - p_lo
    return p_lo, p_hi


_ones_cache: dict[tuple[int, torch.device], torch.Tensor] = {}


def _unit_scales(n: int, device: torch.device) -> torch.Tensor:
    """(n,) f32 ones on ``device``: the per-channel scales of a dequant by one scalar."""
    ones = _ones_cache.get((n, device))
    if ones is None:
        ones = _ones_cache[(n, device)] = torch.ones(n, dtype=torch.float32, device=device)
    return ones


def _dgrad(dy: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, in_hw: tuple[int, int],
           stride: int, lo: int, lhs_d: int, mesh=None) -> torch.Tensor:
    """The STE data gradient of ``conv_i8(quant(x), wq, stride, (lo, _), lhs_d)``
    dequantized by ``sw``: ``dx = conv_i8(quant(dy * sw), flipT(wq)) * s_dy``, as JAX
    ``_q_bwd`` and ``_qat_bwd`` compute it, in ``dy.dtype``.

    The high pad is solved per axis; where the two axes' differ (a non-square input),
    the larger one runs and the extra outputs past the input's extent are cut off.
    ``s_dy`` is the whole batch's over ``mesh``'s ranks (:func:`absmax_scale`).
    """
    k = wq.shape[2]
    dyp = dy.float() * sw.view(1, -1, 1, 1)
    s_dy = absmax_scale(dyp, mesh)
    if dy.shape[2] == 0:  # an empty band: the scale's collective joined, no launch
        return dy.new_zeros((dy.shape[0], wq.shape[1]) + tuple(in_hw)).contiguous(
            memory_format=torch.channels_last)
    dq = quant_i8(dyp, s_dy).contiguous(memory_format=torch.channels_last)
    w_t = wq.flip(2, 3).transpose(0, 1).contiguous(memory_format=torch.channels_last)
    pads = [_dgrad_pad(i, o, k, stride, lhs_d, lo) for i, o in zip(in_hw, dy.shape[2:])]
    hi = max(p[1] for p in pads)
    dx = conv_i8(dq, w_t, lhs_d, (pads[0][0], hi), stride,
                 out=Dequant(s_dy, _unit_scales(w_t.shape[0], dq.device), None, dy.dtype))
    if tuple(dx.shape[2:]) != tuple(in_hw):
        dx = dx[:, :, : in_hw[0], : in_hw[1]]
    return dx


def _empty_out(x: torch.Tensor, wq: torch.Tensor, stride: int, lo: int, hi: int,
               lhs_d: int) -> torch.Tensor:
    """The output of an int8 conv of an empty band: no row, the conv's width, x's dtype."""
    w_out = conv_out_size(x.shape[3], wq.shape[3], stride, lo, hi, lhs_d)
    return x.new_zeros((x.shape[0], wq.shape[0], 0, w_out)).contiguous(
        memory_format=torch.channels_last)


class _FrozenInt8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, sw, b, padding, stride, mesh, s_in):
        if s_in is None:
            s_in = absmax_scale(x, mesh)
        ctx.save_for_backward(wq, sw)
        ctx.geometry = (tuple(x.shape[2:]), padding, stride)
        ctx.mesh = mesh
        if x.shape[2] == 0:
            return _empty_out(x, wq, stride, padding, padding, 1)
        return conv_i8(quant_i8(x, s_in), wq, stride, padding,
                       out=Dequant(s_in, sw, b, x.dtype))

    @staticmethod
    def backward(ctx, dy):
        wq, sw = ctx.saved_tensors
        in_hw, padding, stride = ctx.geometry
        return (_dgrad(dy, wq, sw, in_hw, stride, padding, 1, ctx.mesh),
                None, None, None, None, None, None, None)


def conv2d_frozen_int8(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: torch.Tensor | None,
    padding: int = 1,
    stride: int = 1,
    mesh=None,
    s_in: torch.Tensor | None = None,
) -> torch.Tensor:
    """Zero-padded conv of a FROZEN layer in int8 (JAX ``conv2d_frozen_int8``).

    Forward: ``dequant(conv(quant(x), wq)) + b`` with a dynamic per-tensor input
    scale, ``acc * (s_in * sw) + b`` in f32, cast to ``x.dtype``. Backward (STE): the
    data gradient as a second int8 conv (:func:`_dgrad`); ``wq``, ``sw`` and ``b``
    get none (the layer is frozen). Neither direction falls back to a real-dtype conv.
    With ``mesh``, both directions' dynamic scales are the whole batch's over its
    ranks (:func:`absmax_scale`). ``s_in`` gives the input scale instead: a banded
    caller takes it over its own rows before it gathers the halo rows ``x`` holds.
    An ``x`` of no row (an empty band) launches nothing and still joins the scales'
    collectives.
    """
    return _FrozenInt8Conv.apply(x, wq, sw, b, padding, stride, mesh, s_in)


def _weight_grad(xhat: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, stride: int, lo: int,
                 hi: int, lhs_d: int) -> torch.Tensor:
    """The real-dtype weight gradient of ``conv(xhat, w)`` with pads (lo, hi) and lhs
    dilation ``lhs_d``, on cuDNN (``aten.convolution_backward``, the weight alone).

    An lhs-dilated conv is the transpose conv of the flipped, swapped weight with
    padding ``k - 1 - lo`` and output padding ``hi - lo``: its weight gradient is
    taken in that form and turned back.
    """
    mask = [False, True, False]
    if lhs_d == 1:
        if lo != hi:
            xhat, lo = F.pad(xhat, (lo, hi, lo, hi)), 0
        return torch.ops.aten.convolution_backward(
            dy, xhat, w, None, [stride] * 2, [lo] * 2, [1, 1], False, [0, 0], 1, mask)[1]
    k = w.shape[2]
    if stride != 1 or not 0 <= lo <= k - 1 or not 0 <= hi - lo < lhs_d:
        raise ValueError(f"conv2d_qat_int8: an lhs-dilated conv takes stride 1, 0 <= lo < k "
                         f"and 0 <= hi - lo < lhs_dilation, got {stride}, {(lo, hi)}, {lhs_d}")
    w_t = w.flip(2, 3).transpose(0, 1)
    dw_t = torch.ops.aten.convolution_backward(
        dy, xhat, w_t, None, [lhs_d] * 2, [k - 1 - lo] * 2, [1, 1], True, [hi - lo] * 2, 1,
        mask)[1]
    return dw_t.transpose(0, 1).flip(2, 3)


class _QatInt8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, lo, hi, lhs_d, mesh, s_x):
        if s_x is None:
            s_x = absmax_scale(x, mesh)
        xq = quant_i8(x, s_x).contiguous(memory_format=torch.channels_last)
        wq, sw = quant_weight(w)
        ctx.save_for_backward(xq, s_x, wq, sw, w)
        ctx.geometry = (stride, lo, hi, lhs_d, b.dtype)
        ctx.mesh = mesh
        if x.shape[2] == 0:
            return _empty_out(x, wq, stride, lo, hi, lhs_d)
        return conv_i8(xq, wq, stride, (lo, hi), lhs_d, out=Dequant(s_x, sw, b.float(), x.dtype))

    @staticmethod
    def backward(ctx, dy):
        xq, s_x, wq, sw, w = ctx.saved_tensors
        stride, lo, hi, lhs_d, b_dtype = ctx.geometry
        if xq.shape[2] == 0:  # an empty band: its part of dw and db is 0
            dw, db = torch.zeros_like(w), dy.new_zeros(w.shape[0], dtype=torch.float32)
        else:
            xhat = (xq.float() * s_x).to(dy.dtype)
            dw = _weight_grad(xhat, dy, w.to(dy.dtype), stride, lo, hi, lhs_d)
            db = dy.float().sum((0, 2, 3))
        dx = _dgrad(dy, wq, sw, tuple(xq.shape[2:]), stride, lo, lhs_d, ctx.mesh)
        return dx, dw.to(w.dtype), db.to(b_dtype), None, None, None, None, None, None


def conv2d_qat_int8(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    lhs_dilation: int = 1,
    mesh=None,
    s_x: torch.Tensor | None = None,
) -> torch.Tensor:
    """Int8 conv of a TRAINED layer, quantization-aware (JAX ``conv2d_qat_int8``).

    ``x`` NCHW, ``w`` OIHW (a transpose conv's weight already in conv form: flipped,
    in and out swapped), ``padding`` zero pads ``(lo, hi)`` on both axes after the
    zero-insert ``lhs_dilation``. Forward: ``s_x = absmax(x) / 127``, ``xq = quant(x)``,
    ``wq, sw = quant_weight(w)``, then ``acc * (s_x * sw) + b`` in f32, cast to
    ``x.dtype``. Backward (STE through both quantizers): ``dw`` the real-dtype weight
    gradient over ``xhat = xq * s_x`` against ``dy`` (:func:`_weight_grad`), ``db`` the
    f32 sum of ``dy``, both in their primals' dtypes; ``dx`` the int8 dgrad
    (:func:`_dgrad`), the forward's stride as its lhs dilation and its lhs dilation as
    its window stride. With ``mesh``, ``s_x`` and the dgrad's scale are the whole
    batch's over its ranks (:func:`absmax_scale`). ``s_x`` given and an empty ``x`` as
    for :func:`conv2d_frozen_int8`; an empty band's ``dw`` and ``db`` are 0.
    """
    lo, hi = _pads(padding)
    return _QatInt8Conv.apply(x, w, b, stride, lo, hi, lhs_dilation, mesh, s_x)

"""Hopper kernel K2: int8 convolution with exact int32 accumulation (``csrc/qconv.cu``).

Replaces the XLA int8 convolutions of the JAX package
(``conv_general_dilated`` on int8 operands, ``preferred_element_type=int32``):
``models/transformer_q.py:62`` (``_conv_i8``), ``ops/qconv.py:68``
(``_conv_i8``, under ``conv2d_frozen_int8``) and ``models/resnet_q.py:111``
(``_conv_i8_dyn``). PyTorch has no int8 convolution on CUDA.

An implicit GEMM on the s8 tensor cores (``mma.sync`` m16n8k32), reading the
unpadded int8 NHWC input: zero or reflect padding and the zero-insert lhs
dilation of a transpose conv are address arithmetic. Epilogues: the int32
sum, its bf16, or ``acc * (s_in * sw) + b`` dequantized to f32 or bf16. What
bounds it, and its design, are in the source's header.

The plain version, :func:`artist_style_transfer_tpu_torch.ops.qconv.conv_i8_plain`,
lives beside the dispatcher; this wrapper takes CUDA tensors only and never
falls back.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.ops.cuda import build
from artist_style_transfer_tpu_torch.ops.qconv import Dequant, conv_out_size

LAUNCHES = 0  # wrapper calls that launched the kernel

CIN_MULTIPLE = 32  # the K loop's step: 32 input channels of one tap (csrc/qconv.cu kBK)

_STORE = {torch.int32: 0, torch.bfloat16: 1}
_DEQUANT_STORE = {torch.float32: 2, torch.bfloat16: 3}


def _channels_last_int8(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int8 or t.dim() != 4:
        raise ValueError(f"K2 takes a 4-d int8 {what}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"K2 needs the {what} contiguous in channels_last, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"K2 reads the {what} in 16-byte copies; its data is misaligned")


def _f32_on(t: torch.Tensor, device: torch.device, numel: int, what: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or t.numel() != numel:
        raise ValueError(f"K2's dequant {what} must be {numel} f32 values on {device}, got "
                         f"{t.numel()} {t.dtype} on {t.device}")
    return t.contiguous()


def conv_i8_cuda(
    xq: torch.Tensor,
    wq: torch.Tensor,
    stride: int,
    pad_lo: int,
    pad_hi: int,
    dilation: int,
    reflect: bool,
    out: torch.dtype | Dequant,
) -> torch.Tensor:
    """K2 on CUDA int8 NCHW ``xq`` and OIHW ``wq`` (``channels_last``) -> NCHW
    ``channels_last`` output of the ``out`` epilogue. The argument checks of
    :func:`ops.qconv.conv_i8` have run; this checks what the kernel needs."""
    global LAUNCHES
    if not (xq.is_cuda and wq.is_cuda and xq.device == wq.device):
        raise ValueError(f"K2 takes CUDA tensors on one device, got {xq.device} and {wq.device}")
    _channels_last_int8(xq, "input")
    _channels_last_int8(wq, "weight")
    n, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    if cin % CIN_MULTIPLE:
        raise ValueError(f"K2 takes C_in a multiple of {CIN_MULTIPLE}, got {cin}")
    if cout % 2:
        raise ValueError(f"K2 stores output channels in pairs: C_out must be even, got {cout}")
    ho = conv_out_size(h, kh, stride, pad_lo, pad_hi, dilation)
    wo = conv_out_size(w, kw, stride, pad_lo, pad_hi, dilation)
    s_in = sw = bias = None
    if isinstance(out, Dequant):
        if out.dtype not in _DEQUANT_STORE:
            raise ValueError(f"K2 dequantizes to float32 or bfloat16, got {out.dtype}")
        epilogue, dtype = _DEQUANT_STORE[out.dtype], out.dtype
        s_in = _f32_on(out.s_in, xq.device, 1, "s_in")
        sw = _f32_on(out.sw, xq.device, cout, "sw")
        if out.bias is not None:
            bias = _f32_on(out.bias, xq.device, cout, "bias")
    elif out in _STORE:
        epilogue, dtype = _STORE[out], out
    else:
        raise ValueError(f"out must be torch.int32, torch.bfloat16 or a Dequant, got {out!r}")
    if n * ho * wo * max(cout, cin) >= 2**31 or n * h * w * cin >= 2**31:
        raise ValueError(f"K2 indexes pixels with 32-bit ints; {tuple(xq.shape)} is too large")
    lib = build.library()
    y = torch.empty((n, cout, ho, wo), dtype=dtype, device=xq.device,
                    memory_format=torch.channels_last)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(xq.device):
        code = lib.ast_qconv(
            xq.data_ptr(), wq.data_ptr(), y.data_ptr(), n, h, w, cin, cout, kh, kw, stride,
            pad_lo, dilation, int(reflect), ho, wo, epilogue, ptr(s_in), ptr(sw), ptr(bias),
            torch.cuda.current_stream(xq.device).cuda_stream,
        )
    build.check(code, "qconv kernel launch")
    LAUNCHES += 1
    return y

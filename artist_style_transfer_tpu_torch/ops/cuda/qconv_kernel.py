"""Hopper kernel K2: int8 convolution with exact int32 accumulation (``csrc/qconv.cu``).

Replaces the XLA int8 convolutions of the JAX package
(``conv_general_dilated`` on int8 operands, ``preferred_element_type=int32``):
``models/transformer_q.py:62`` (``_conv_i8``), ``ops/qconv.py:68``
(``_conv_i8``, under ``conv2d_frozen_int8``) and ``models/resnet_q.py:111``
(``_conv_i8_dyn``). PyTorch has no int8 convolution on CUDA.

An implicit GEMM on Hopper's warpgroup MMA (``wgmma`` m64nNk32 s8 x s8 -> s32),
reading the unpadded int8 NHWC input: zero or reflect padding are address
arithmetic, and an lhs-dilated (transpose) conv runs as its sub-pixel classes,
ordinary convs over the undilated input, all in one launch, so the inserted
zeros are never multiplied. K moves through shared memory in units of 128 bytes
(:data:`qconv_plan.K_STEP`), one or more a pipeline stage; A is either gathered
per unit or, for the 3x3 convs, read by the MMA out of a per-warpgroup input
halo copied once a 128-channel slice; where the tiles under-fill the card,
split-K sums exact int32 partials in the same launch. Epilogues: the int32
sum, its bf16, or ``acc * (s_in * sw) + b`` dequantized to f32 or bf16. What
bounds it, and its design, are in the source's header.

The host plan (:mod:`qconv_plan`: tile, classes and their taps, split-K, and
the shape checks) is computed once a shape and cached with its table on the
device, so a call is one lookup, one ``torch.empty`` and one ``ctypes`` call.
The split-K workspace is cached per device, zero between launches (the kernel
leaves it so), and shared by the launches of one stream.

The plain version, :func:`artist_style_transfer_tpu_torch.ops.qconv.conv_i8_plain`,
lives beside the dispatcher; this wrapper takes CUDA tensors only and never
falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from artist_style_transfer_tpu_torch.ops.cuda import build
from artist_style_transfer_tpu_torch.ops.cuda.qconv_plan import QconvPlan, plan_qconv
from artist_style_transfer_tpu_torch.ops.qconv import Dequant, _check

LAUNCHES = 0  # wrapper calls that launched the kernel

_STORE = {torch.int32: 0, torch.bfloat16: 1}
_DEQUANT_STORE = {torch.float32: 2, torch.bfloat16: 3}


class _Entry(NamedTuple):
    plan: QconvPlan
    args: ctypes.Array  # the plan's host ints, kept alive for their address
    address: int
    out_shape: tuple[int, int, int, int]
    tables: dict[int, tuple[torch.Tensor, torch.Tensor]]  # by device: the table, its pinned source


_entries: dict[tuple, _Entry] = {}
_workspaces: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def plan_for(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad_lo: int, pad_hi: int,
             dilation: int, reflect: bool) -> QconvPlan:
    """The plan K2 runs for these arguments (checked and cached as a call would)."""
    return _entry(xq, wq, stride, pad_lo, pad_hi, dilation, reflect).plan


def use_tile(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad_lo: int, pad_hi: int,
             dilation: int, reflect: bool, tile: tuple[int, int, int] | None) -> QconvPlan:
    """Run these arguments' shape with ``tile`` (BM, BN, splits) from now on, or with
    the cost model's pick again where ``tile`` is None; returns the plan. For timing
    the tiles against each other (``bench_qconv.py --sweep``)."""
    return _entry(xq, wq, stride, pad_lo, pad_hi, dilation, reflect, tile, replace=True).plan


def _entry(xq, wq, stride, pad_lo, pad_hi, dilation, reflect, tile=None,
           replace: bool = False) -> _Entry:
    key = (xq.shape, xq.dtype, wq.shape, wq.dtype, stride, pad_lo, pad_hi, dilation, reflect)
    entry = _entries.get(key)
    if entry is None or replace:
        _check(xq, wq, stride, pad_lo, pad_hi, dilation, "reflect" if reflect else "zeros")
        plan = plan_qconv(tuple(xq.shape), tuple(wq.shape), stride, pad_lo, pad_hi, dilation,
                          reflect, tile)
        args = (ctypes.c_int * len(plan.args()))(*plan.args())
        entry = _entries[key] = _Entry(plan, args, ctypes.addressof(args),
                                       (plan.n, plan.cout, plan.ho, plan.wo), {})
    return entry


def _workspace(device: torch.device, plan: QconvPlan) -> tuple[int, int]:
    """Pointers to zeroed split-K partials and counters on ``device``, grown as needed."""
    ws, cnt = _workspaces.get(device, (None, None))
    if ws is None or ws.numel() < plan.workspace_ints or cnt.numel() < plan.counters:
        ws = torch.zeros(max(plan.workspace_ints, 0 if ws is None else ws.numel()),
                         dtype=torch.int32, device=device)
        cnt = torch.zeros(max(plan.counters, 0 if cnt is None else cnt.numel()),
                          dtype=torch.int32, device=device)
        _workspaces[device] = (ws, cnt)
    return ws.data_ptr(), cnt.data_ptr()


def _int8_nhwc(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"K2 needs the {what} contiguous in channels_last, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"K2 reads the {what} in 16-byte copies; its data is misaligned")


def _f32_on(t: torch.Tensor, device: torch.device, numel: int, what: str) -> int:
    if t.device != device or t.dtype != torch.float32 or t.numel() != numel \
            or not t.is_contiguous():
        raise ValueError(f"K2's dequant {what} must be {numel} contiguous f32 values on "
                         f"{device}, got {t.numel()} {t.dtype} on {t.device}")
    return t.data_ptr()


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
    ``channels_last`` output of the ``out`` epilogue. The checks that depend on the
    shapes and dtypes (those of :func:`ops.qconv.conv_i8` and what the kernel
    takes) run once a key, when its plan is made; the rest run every call."""
    global LAUNCHES
    index = xq.get_device()  # -1 on the CPU
    if index < 0 or wq.get_device() != index:
        raise ValueError(f"K2 takes CUDA tensors on one device, got {xq.device} and {wq.device}")
    entry = _entry(xq, wq, stride, pad_lo, pad_hi, dilation, reflect)
    _int8_nhwc(xq, "input")
    _int8_nhwc(wq, "weight")
    device = xq.device
    s_in = sw = bias = None
    if isinstance(out, Dequant):
        if out.dtype not in _DEQUANT_STORE:
            raise ValueError(f"K2 dequantizes to float32 or bfloat16, got {out.dtype}")
        epilogue, dtype = _DEQUANT_STORE[out.dtype], out.dtype
        s_in = _f32_on(out.s_in, device, 1, "s_in")
        sw = _f32_on(out.sw, device, entry.plan.cout, "sw")
        if out.bias is not None:
            bias = _f32_on(out.bias, device, entry.plan.cout, "bias")
    elif out in _STORE:
        epilogue, dtype = _STORE[out], out
    else:
        raise ValueError(f"out must be torch.int32, torch.bfloat16 or a Dequant, got {out!r}")
    lib = build.library()
    y = torch.empty(entry.out_shape, dtype=dtype, device=device,
                    memory_format=torch.channels_last)
    ws, counters = _workspace(device, entry.plan) if entry.plan.splits > 1 else (None, None)
    if index not in entry.tables:  # one copy to the device a shape, from pinned memory
        pinned = torch.tensor(entry.plan.table(), dtype=torch.int32).pin_memory()
        entry.tables[index] = (pinned.to(device, non_blocking=True), pinned)
    table = entry.tables[index][0]
    args = (entry.address, table.data_ptr(), xq.data_ptr(), wq.data_ptr(), y.data_ptr(), ws,
            counters, s_in, sw, bias, epilogue, torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        code = lib.ast_qconv(*args)
    else:
        with torch.cuda.device(device):
            code = lib.ast_qconv(*args)
    build.check(code, "qconv kernel launch")
    LAUNCHES += 1
    return y

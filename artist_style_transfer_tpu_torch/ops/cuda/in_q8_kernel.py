"""Hopper kernel of the int8 TransformerNet's instance norms (``csrc/in_q8.cu``).

One call runs the whole chain after an int8 conv (or the bf16 stem conv):
the accumulator (int32 or bf16, NHWC) -> instance norm with f32 one-pass statistics
(+ReLU) -> bf16 (+ a bf16 residual) -> the int8 codes of the next conv. It replaces no
TPU kernel: the JAX package's ``_in_act`` and ``_quant_act`` are XLA fusions. It is
bound by bytes; the bytes a call moves and the design are in the source's header.

The statistics stay PyTorch's own reductions in PyTorch's order (the net is chaotic
under their last bits, see the source): the mean of the accumulator with an f32
accumulator, and the mean of its f32 squares, which ``in_q8_square_kernel`` writes.
``in_q8_apply_kernel`` then does the rest in one pass, in the plain composition's
separately rounded f32 operations, so a call gives the plain version's bits,
:func:`artist_style_transfer_tpu_torch.models.transformer_q.in_act_q8_plain`.

The plain version lives beside the dispatcher,
:func:`artist_style_transfer_tpu_torch.models.transformer_q.in_act_q8`; this wrapper
takes CUDA tensors only and never falls back.
"""

from __future__ import annotations

import threading

import torch

from artist_style_transfer_tpu_torch.ops.cuda import build
from artist_style_transfer_tpu_torch.ops.norm import INSTANCE_NORM_EPS

LAUNCHES = 0  # wrapper calls that launched the kernels
_count_lock = threading.Lock()  # the serving stack's threads may call at once

VEC = 8  # channels a thread owns (csrc/in_q8.cu kVec)
MAX_THREADS = 256  # a block (kMaxThreads)

_ACCUMS = (torch.int32, torch.bfloat16)


def _check(acc, gamma, beta, residual, inv_s, stream: bool) -> None:
    """The shapes, types, layouts and devices the kernel takes; raises on the rest."""
    if acc.dtype not in _ACCUMS:
        raise ValueError(f"in_q8 takes an int32 or bfloat16 accumulator, got {acc.dtype}")
    if acc.dim() != 4 or not acc.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"in_q8 needs an NCHW accumulator contiguous in channels_last, got "
                         f"shape {tuple(acc.shape)} strides {acc.stride()}")
    n, c, h, w = acc.shape
    if c % VEC or c // VEC > MAX_THREADS or n * h * w == 0 or n > 65535:
        raise ValueError(f"in_q8 takes C a multiple of {VEC} up to {VEC * MAX_THREADS}, "
                         f"N up to 65535 and a non-empty image, got shape {tuple(acc.shape)}")
    if acc.data_ptr() % 16:
        raise ValueError("in_q8 reads the accumulator in 16-byte pieces; its data is misaligned")
    for t, what in ((gamma, "gamma"), (beta, "beta")):
        if t.device != acc.device or t.dtype != torch.float32 or t.numel() != c \
                or not t.is_contiguous():
            raise ValueError(f"in_q8's {what} must be {c} contiguous f32 values on "
                             f"{acc.device}, got {t.numel()} {t.dtype} on {t.device}")
    if residual is not None:
        if residual.dtype != torch.bfloat16 or residual.shape != acc.shape \
                or residual.device != acc.device \
                or not residual.is_contiguous(memory_format=torch.channels_last) \
                or residual.data_ptr() % 16:
            raise ValueError(f"in_q8's residual must be a 16-byte aligned bf16 tensor of the "
                             f"accumulator's shape {tuple(acc.shape)} in channels_last on "
                             f"{acc.device}, got {residual.dtype} {tuple(residual.shape)} "
                             f"strides {residual.stride()} on {residual.device}")
    if inv_s is not None and (inv_s.dtype != torch.float32 or inv_s.numel() != 1
                              or inv_s.device != acc.device):
        raise ValueError(f"in_q8's inv_s must be one f32 value on {acc.device}, got "
                         f"{inv_s.numel()} {inv_s.dtype} on {inv_s.device}")
    if inv_s is None and not stream:
        raise ValueError("in_q8 has nothing to write: ask for the stream, the codes or both")


def in_q8_cuda(acc: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, relu: bool,
               residual: torch.Tensor | None = None, inv_s: torch.Tensor | None = None,
               stream: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The fused instance norm on a CUDA accumulator (NCHW, ``channels_last``):
    ``(the bf16 stream or None, the int8 codes or None)``, the stream where ``stream``,
    the codes where ``inv_s`` (the next conv's ``1 / s``, f32 on the device) is given,
    both ``channels_last``."""
    global LAUNCHES
    _check(acc, gamma, beta, residual, inv_s, stream)
    if not acc.is_cuda:
        raise ValueError(f"in_q8 takes CUDA tensors, got device {acc.device}")
    n, c, h, w = acc.shape
    x_int32 = int(acc.dtype == torch.int32)
    lib = build.library()
    raw = torch._C._cuda_getCurrentRawStream(acc.get_device())
    with torch.cuda.device(acc.device):
        # PyTorch sums a bf16 tensor into f32 in the order it sums the tensor's f32 copy.
        mean = acc.mean(dim=(2, 3), dtype=torch.float32).contiguous()
        sq = torch.empty_like(acc, dtype=torch.float32, memory_format=torch.channels_last)
        build.check(lib.ast_in_q8_square(acc.data_ptr(), sq.data_ptr(), x_int32, acc.numel(),
                                         raw), "in_q8 square kernel launch")
        m2 = sq.mean(dim=(2, 3)).contiguous()
        del sq
        out = torch.empty_like(acc, dtype=torch.bfloat16, memory_format=torch.channels_last) \
            if stream else None
        codes = torch.empty_like(acc, dtype=torch.int8, memory_format=torch.channels_last) \
            if inv_s is not None else None
        build.check(lib.ast_in_q8_apply(
            acc.data_ptr(), mean.data_ptr(), m2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if inv_s is None else inv_s.data_ptr(), None if out is None else out.data_ptr(),
            None if codes is None else codes.data_ptr(), x_int32, n, h * w, c, int(relu),
            INSTANCE_NORM_EPS, raw), "in_q8 apply kernel launch")
    with _count_lock:
        LAUNCHES += 1
    return out, codes

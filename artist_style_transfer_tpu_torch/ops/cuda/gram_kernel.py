"""Hopper kernel for batched normalized Gram matrices (``csrc/gram.cu``).

Replaces the Pallas TPU kernel
``artist_style_transfer_tpu/ops/pallas/gram_kernel.py:gram_matrix_pallas``:
G[n] = F[n]^T F[n] / (C*H*W) for NHWC features, f32 accumulation, scale
fused, output (N, C, C) f32.

What bounds it on the H100: at the VGG tap shapes each tap is the same
2*HW*C^2 FLOPs against a few MB of input, so in parity mode (no TF32) the
kernel is bound by FP32 FMA throughput on the CUDA cores, not by memory.
Split-K over HW is what fills the SMs: relu1_2 at N=1 has a single 64x64
output tile, so the HW axis is cut into enough splits to put about four
blocks on every SM, and a second small kernel sums the partials in a fixed
order (deterministic, no atomics).

The plain version, :func:`artist_style_transfer_tpu_torch.ops.gram.gram_matrix_plain`,
lives beside the dispatcher; this wrapper takes CUDA tensors only and never
falls back.
"""

from __future__ import annotations

import torch

LAUNCHES = 0  # wrapper calls that launched the kernel

TILE = 64  # output tile edge (csrc/gram.cu kTile)
CHUNK = 16  # HW rows per shared-memory pass (csrc/gram.cu kChunk)
MIN_ROWS_PER_SPLIT = 64
BLOCKS_PER_SM = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(n: int, hw: int, c: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows_per_split) putting about ``BLOCKS_PER_SM`` blocks on each SM."""
    tiles = (-(-c // TILE)) ** 2
    want = max(1, -(-(BLOCKS_PER_SM * sm_count) // (n * tiles)))
    rows = -(-hw // want)
    rows = max(MIN_ROWS_PER_SPLIT, -(-rows // CHUNK) * CHUNK)
    return -(-hw // rows), rows


def gram_matrix_cuda(features_nhwc: torch.Tensor) -> torch.Tensor:
    """Normalized Gram of a contiguous NHWC CUDA tensor (f32 or bf16) -> (N, C, C) f32."""
    global LAUNCHES
    f = features_nhwc
    if not f.is_cuda:
        raise ValueError(f"gram kernel takes CUDA tensors, got device {f.device}")
    if f.dtype not in _DTYPE_CODE:
        raise ValueError(f"gram kernel takes float32 or bfloat16, got {f.dtype}")
    if f.dim() != 4:
        raise ValueError(f"gram kernel takes an NHWC tensor, got shape {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError(
            "gram kernel needs a contiguous NHWC tensor (run the producer in "
            f"channels_last); got strides {f.stride()} for shape {tuple(f.shape)}"
        )
    n, h, w, c = f.shape
    hw = h * w
    if n * hw * c == 0:
        raise ValueError(f"gram kernel got an empty tensor of shape {tuple(f.shape)}")
    from artist_style_transfer_tpu_torch.ops.cuda import build

    lib = build.library()
    with torch.cuda.device(f.device):
        sms = torch.cuda.get_device_properties(f.device).multi_processor_count
        splits, rows = split_plan(n, hw, c, sms)
        ws = torch.empty((n, splits, c, c), dtype=torch.float32, device=f.device)
        out = torch.empty((n, c, c), dtype=torch.float32, device=f.device)
        scale = 1.0 / float(c * h * w)
        code = lib.ast_gram(
            f.data_ptr(), ws.data_ptr(), out.data_ptr(), _DTYPE_CODE[f.dtype],
            n, hw, c, splits, rows, scale, torch.cuda.current_stream(f.device).cuda_stream,
        )
        build.check(code, "gram kernel launch")
    LAUNCHES += 1
    return out

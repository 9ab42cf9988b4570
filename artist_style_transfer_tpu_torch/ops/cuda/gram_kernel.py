"""Hopper kernel for batched normalized Gram matrices (``csrc/gram.cu``).

Replaces the Pallas TPU kernel
``artist_style_transfer_tpu/ops/pallas/gram_kernel.py:gram_matrix_pallas``:
G[n] = F[n]^T F[n] / (C*H*W) for NHWC features, f32 accumulation, scale
fused, output (N, C, C) f32.

What bounds it on the H100: a tap is HW*C*(C+1) distinct FLOPs against a
few MB of input. The kernel runs on the tensor cores through wgmma: 3xTF32
for f32 input (f32-accurate products, three TF32 MMAs each, two on a
diagonal tile), one bf16 pass for bf16. It computes only the tiles with
ti <= tj (64x64 for C <= 64, else 128x128) and mirrors them. Split-K over
HW fills the SMs (relu1_2 at N=1 is a single tile); in the same launch the
last block to finish a group of ``GROUP`` splits sums their partials in split
order and the last group sums the group sums in group order, so the result
is deterministic with no atomics in the sums.

The workspace and the per-tile arrival counters are cached per device and
shared by every call, so calls on concurrent streams of one device are not
supported: launch the kernel from one stream at a time.

The plain version, :func:`artist_style_transfer_tpu_torch.ops.gram.gram_matrix_plain`,
lives beside the dispatcher; this wrapper takes CUDA tensors only and never
falls back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from artist_style_transfer_tpu_torch.ops.cuda import build

LAUNCHES = 0  # wrapper calls that launched the kernel

WIDE_ROWS = 1024  # HW rows a 128-wide block must get, on one wave, for the wide tile
ROWS = 64  # a multiple of the HW rows per pipeline stage: 32 f32, 64 bf16 (csrc/gram.cu kRows)
GROUP = 8  # split partials per group of the two-level sum (csrc/gram.cu kGroup)
MIN_ROWS_PER_SPLIT = 128
MAX_SPLITS = 128  # the last block of a tile reads GROUP + splits / GROUP partial tiles
BLOCKS_PER_SM = {64: 2, 128: 1}  # resident blocks by tile edge: shared memory holds so many
SPLIT_COST_ROWS = 256  # a split's fixed cost (prologue, partial tile, sums) in HW rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class GramPlan(NamedTuple):
    tile: int  # edge of G's tiles
    pairs: tuple[tuple[int, int], ...]  # (ti, tj), ti <= tj, in launch order (grid y)
    splits: int  # HW splits per tile (grid x)
    rows: int  # HW rows per split, a multiple of ROWS


def tile_edge(n: int, hw: int, c: int, sm_count: int) -> int:
    """128 (two warpgroups a block, half the reads of F) where C > 64 and one
    wave of 128-wide blocks still gets ``WIDE_ROWS`` rows each; else 64."""
    if c <= 64:
        return 64
    wide = len(tile_pairs(c, 128))
    return 128 if n * wide * hw >= WIDE_ROWS * BLOCKS_PER_SM[128] * sm_count else 64


def tile_pairs(c: int, tile: int) -> tuple[tuple[int, int], ...]:
    """Upper-triangle tiles of a (C, C) Gram, row-major: the kernel decodes grid y so."""
    t = -(-c // tile)
    return tuple((i, j) for i in range(t) for j in range(i, t))


@functools.lru_cache(maxsize=256)
def gram_plan(n: int, hw: int, c: int, sm_count: int) -> GramPlan:
    """Tiles and HW splits, at most ``MAX_SPLITS``, every split non-empty.

    The split count minimises waves x (rows per split + ``SPLIT_COST_ROWS``),
    a wave being ``BLOCKS_PER_SM`` blocks on every SM: more splits fill the
    card, but each adds a fixed cost and a partial tile to sum.
    """
    tile = tile_edge(n, hw, c, sm_count)
    pairs = tile_pairs(c, tile)
    slots = BLOCKS_PER_SM[tile] * sm_count

    def cost(s: int) -> int:
        return -(-n * len(pairs) * s // slots) * (-(-hw // s) + SPLIT_COST_ROWS)

    want = min(range(1, MAX_SPLITS + 1), key=lambda s: (cost(s), s))
    rows = -(-hw // want)
    rows = max(MIN_ROWS_PER_SPLIT, -(-rows // ROWS) * ROWS)
    return GramPlan(tile, pairs, -(-hw // rows), rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}  # device -> (workspace, counters)


def _workspace(device: torch.device, floats: int, tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's cached workspace and zeroed counters, grown when too small."""
    ws, counters = _scratch.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    _scratch[device.index] = (ws, counters)
    return ws, counters


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
    lib = build.library()
    plan = gram_plan(n, hw, c, _sm_count(f.device.index))
    tiles = n * len(plan.pairs)
    ws = counters = None
    if plan.splits > 1:
        groups = -(-plan.splits // GROUP)
        ws, counters = _workspace(f.device, tiles * (plan.splits + groups) * plan.tile**2,
                                  tiles * (groups + 1))
    out = torch.empty((n, c, c), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        code = lib.ast_gram(
            f.data_ptr(), ws.data_ptr() if ws is not None else None,
            counters.data_ptr() if counters is not None else None, out.data_ptr(),
            _DTYPE_CODE[f.dtype], plan.tile, n, hw, c, plan.splits, plan.rows, 1.0 / float(c * hw),
            torch.cuda.current_stream(f.device).cuda_stream,
        )
    build.check(code, "gram kernel launch")
    LAUNCHES += 1
    return out

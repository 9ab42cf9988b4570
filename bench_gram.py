#!/usr/bin/env python3
"""The Gram kernel K1 on the card: device time at the VGG tap shapes, for A/B runs.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 bench_gram.py                # this checkout's kernel
    python3 bench_gram.py --root DIR     # the kernel of the port package under DIR,
                                         # e.g. an earlier commit unpacked with git archive
    python3 bench_gram.py --sweep        # this checkout's kernel over its plan constants

Shapes are those of ``chip_smoke.py``'s gram phase: the four VGG16 taps at
256x256 N=1 (Gatys) and 512x512 N=4, f32 and bf16. Each line holds the
device time per call from ``torch.profiler`` with L2 flushed before each
call (every gram kernel the wrapper launches), the CUDA-event time of warm calls,
and the bound of ``chip_smoke.gram_bound``. Compare two versions only
within one run of the tool on one card, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke


def shapes():
    for size, n in ((chip_smoke.GATYS_SIZE, 1), (512, 4)):
        for tap, down, c in chip_smoke.TAPS:
            for dtype in (torch.float32, torch.bfloat16):
                yield size, n, tap, size // down, c, dtype


def measure(gram_kernel, peaks: dict, label: str, dtypes=(torch.float32, torch.bfloat16)) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for size, n, tap, side, c, dtype in shapes():
        if dtype not in dtypes:
            continue
        f = torch.rand((n, side, side, c), generator=gen, device="cuda").to(dtype)
        run = lambda: gram_kernel.gram_matrix_cuda(f)  # noqa: E731
        t_ops, t_bytes = chip_smoke.gram_bound(n, side * side, c, dtype, peaks)
        print(json.dumps({
            "label": label, "tap": tap, "size": size, "n": n, "c": c, "dtype": str(dtype)[6:],
            "device_ms": chip_smoke.device_ms(run, "gram"), "kernel_ms": chip_smoke.time_ms(run),
            "bound_ms": max(t_ops, t_bytes),
        }), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="directory holding the artist_style_transfer_tpu_torch package")
    parser.add_argument("--sweep", action="store_true",
                        help="time with the wide tile always, by the plan's rule, and never")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gram: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    smi = chip_smoke.phase_header()
    _, peaks = chip_smoke.peaks_for(smi)
    if not args.sweep:
        measure(gram_kernel, peaks, os.path.abspath(args.root))
        return 0
    for wide_rows in (0, 1024, 1 << 30):  # always, by the rule, never the wide tile
        gram_kernel.WIDE_ROWS = wide_rows
        gram_kernel.gram_plan.cache_clear()
        measure(gram_kernel, peaks, f"wide_rows={wide_rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

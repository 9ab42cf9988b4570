"""Run one cell of the port's benchmark once, on the card this machine holds.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name from ``BENCHMARK.json`` at
the checkout's root. The last line of standard output is the result; the numbers that
decide ``correct`` are also the last lines of standard error. Without CUDA, or with fewer
cards than the cell asks for, it exits 2 and prints no result.

Host threads are fixed (``THREADS``) before torch is imported, and every build or kernel
cache the program or torch may write sits at a fixed path under ``build/`` in the checkout.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

THREADS = 4
BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_compute_cache"}


def _environment() -> None:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from benchlib import manifest

    chips = manifest.cell(args.workload, manifest.manifest())["chips"]

    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    from benchlib import runner

    result = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), t_start, THREADS)
    return runner.finish(result)


if __name__ == "__main__":
    sys.exit(main())

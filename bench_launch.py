#!/usr/bin/env python3
"""What the port's process launcher and its rank jobs' profiler cost, for A/B runs.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 bench_launch.py              # this checkout's parallel.launch and profiler
    python3 bench_launch.py --root DIR   # the launcher of the port package under DIR,
                                         # e.g. an earlier commit unpacked with git archive

1. ``parallel.launch`` of a job that does nothing but return, over gloo ranks on
   cuda:0 (NCCL refuses two ranks on one card): 2 and 4 ranks; 2 and 4 ranks with
   ``ARGS_MB`` of arguments; 2 ranks each returning ``RESULTS_MB``. Each line gives
   the launch's seconds, the seconds from the call to the job's start in rank 0 (start-up,
   imports, the arguments) and from the job's end to the call's return (the results,
   teardown).
2. The profiler of ``parallel.workers._timed`` around a 'cycle' ``train()`` epoch at
   224x224, B=4 (after a warm one), with host and device events and with the device's
   alone: its seconds after the epoch (stop and ``key_averages``) and the device ms it
   reads. Skipped with ``--root``.

Prints one JSON line per measurement; compare two checkouts only within one call on one
card, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# About what chip_smoke.py's joint launches carry: the arguments of its jobs over 2 and 4
# ranks (the seeded images, paintings and nets) and the results of one rank's jobs.
ARGS_MB = 1200
RESULTS_MB = 1000

def job(mesh, payload, results_mb: int) -> dict:
    """The launched job: starts, makes ``results_mb`` of results, returns."""
    start = time.time()
    out = np.ones((results_mb << 20) // 8, np.float64) if results_mb else None
    return {"start": start, "end": time.time(), "out": out}


def launches(launch, workers, label: str) -> None:
    cases = (("empty", 2, 0, 0), ("empty", 4, 0, 0), ("args", 2, ARGS_MB, 0),
             ("args", 4, ARGS_MB, 0), ("results", 2, 0, RESULTS_MB))
    for name, n, a_mb, r_mb in cases:
        payload = np.ones((a_mb << 20) // 8, np.float64) if a_mb else None
        t0 = time.time()
        ranks = launch(workers.run_jobs, n, [(job, (payload, r_mb), {})], backend="gloo",
                       device="cuda:0", threads=None, timeout_s=600)
        t1 = time.time()
        print(json.dumps({"label": label, "case": name, "ranks": n, "args_mb": a_mb,
                          "results_mb_a_rank": r_mb, "launch_s": t1 - t0,
                          "before_job_s": ranks[0][0]["start"] - t0,
                          "after_job_s": t1 - max(r[0]["end"] for r in ranks)}), flush=True)


def profiler_costs() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
    from artist_style_transfer_tpu_torch.train import train

    content, paintings = chip_smoke.train_data()
    kw = dict(style_method="cycle", artist="A", num_epochs=1, batch_size=chip_smoke.TRAIN_BATCH,
              content_images=content, paintings=paintings, save_every=0, wordy=False,
              vgg=init_vgg16(torch.Generator().manual_seed(0), device="cuda"),
              model_dir=None, device="cuda")
    train(**kw)  # warm
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, acts in (("host_and_device", both), ("device", [ProfilerActivity.CUDA])) * 2:
        prof = profile(activities=acts)
        prof.start()
        train(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.stop()
        events = prof.key_averages()
        secs = time.perf_counter() - t0
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        print(json.dumps({"profiler": name, "after_epoch_s": secs,
                          "device_ms": sum(e.self_device_time_total for e in dev) / 1e3}),
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="directory holding the artist_style_transfer_tpu_torch package")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_launch: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from artist_style_transfer_tpu_torch.parallel import launch, workers

    label = os.path.abspath(args.root)
    launches(launch, workers, label)
    if label == os.path.dirname(os.path.abspath(__file__)):
        profiler_costs()
    return 0


if __name__ == "__main__":
    sys.exit(main())

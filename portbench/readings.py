"""The readings that the limits of ``correct`` are set from, on the card, in one process.

    python3 portbench/readings.py --workload <name> --seeds <n> [<n> ...] [--faults]

For each seed: one run of the cell as ``run.py`` makes it, with one pass of units in
place of the measured window (``runner.run_cell(readings=True)``), giving the program's
numbers against the reference, the cell's diagnostics, and the control's numbers (the
reference in the precision below the configuration's, put in the program's place). With
``--faults`` also each fault of ``benchlib.faults`` that the cell's generator can have,
planted under the program (but a training state left unchanged, which reads 1 on
``step_gap`` by its definition). One JSON line a seed; the cell's limits are set from
these by hand and written into ``limits/<workload>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    run._environment()

    import torch

    from benchlib import faults, manifest, runner

    torch.set_num_threads(run.THREADS)
    dev = torch.device("cuda", 0)
    traffic = manifest.traffic(manifest.cell(args.workload, manifest.manifest())["traffic"])
    planted = faults.BY_GENERATOR[traffic["generator"]]

    def read(seed: int, fault: str | None = None) -> dict:
        t = time.perf_counter()
        with planted[fault]() if fault else contextlib.nullcontext():
            r = runner.run_cell(args.workload, seed, 0.0, False, dev, t, run.THREADS,
                                readings=True)
        gc.collect()
        torch.cuda.empty_cache()
        program = {k: v["value"] for k, v in r["checked"].items()}
        return {"program": {**program, **r["diagnostics"]}, "control": r["control"],
                "correct": r["correct"], "seconds": time.perf_counter() - t}

    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed, **read(seed)}
        if args.faults:
            # a state left unchanged reads 1 on step_gap by its definition: no run
            line["faults"] = {f: read(seed, f)["program"] for f in planted if f != "unchanged"}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

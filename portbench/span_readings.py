"""The program's spans in one traced pass of a cell, on the card.

    python3 portbench/span_readings.py --workload <name> --seeds <n> [<n> ...]

For each seed: the cell set up as ``run.py`` sets it up, one pass of its units
(``trace_units``) under the profiler as ``--trace 1`` runs it, and one JSON line: the
traced window and busy seconds, the idle share and idle gaps as the harness reads them,
each ``ast:`` span's count, host seconds, launches, device seconds and idle seconds
(``benchlib.spans``), and what the spans read: ``staging_idle_ms_per_batch`` and
``quantize_ms_per_call`` in the eval cells, ``update_ms_per_step`` in the training cell
(null where the cell has no such span). ``ast_on_device`` counts the device events named
by a span that the harness would take for device work (0 when the profiler flags every
span's annotation). The program's outputs are not checked here.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def read(workload: str, seed: int, device, traffic: dict | None = None) -> dict:
    """One seed's line. ``traffic`` replaces the cell's traffic file (the CPU tests' small
    sizes)."""
    import torch

    from benchlib import generators, manifest, readers, spans, trace

    m = manifest.manifest()
    cell = manifest.cell(workload, m)
    cfg = manifest.config(cell["config"], m)
    traffic = traffic or manifest.traffic(cell["traffic"])
    state = generators.load(traffic["generator"]).setup(cfg, traffic, seed, device)
    n = state.trace_units
    state.prepare_window(n)
    events, host, window, totals = spans.profile_units(
        lambda k: [state.unit(j) for j in range(k)], n, lambda: generators.sync(device))
    steps = n * state.steps_per_unit
    t = trace.summarize(events, host, window, n, n * state.images_per_unit, steps, {})
    state.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "workload": workload, "seed": seed, "window_s": t.window_s, "busy_s": t.busy_s,
        "idle_share": readers.idle_share(t),
        "readings": {"staging_idle_ms_per_batch": spans.staging_idle_ms_per_batch(totals, steps),
                     "quantize_ms_per_call": spans.quantize_ms_per_call(totals, n),
                     "update_ms_per_step": spans.update_ms_per_step(totals, steps)},
        "spans": {k: v._asdict() for k, v in totals.items()},
        "idle_gaps": t.idle_gaps,
        "ast_on_device": sum(1 for name, _, _ in events if name.startswith(spans.PREFIX)),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    run._environment()

    import torch

    torch.set_num_threads(run.THREADS)
    for seed in args.seeds:
        print(json.dumps(read(args.workload, seed, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured (or traced) window of whole units, the
check of the program's outputs against the reference, and the result line.

The window runs units back to back until ``seconds`` have passed; each unit ends in a
sync, so a rate is the window's images over the time from its start to the end of its
last unit. With ``trace`` one pass of units (the cell's ``trace_units``) runs under the
profiler instead, and the per-layer readers read the trace. ``readings`` runs one such
pass untraced and adds the control's numbers and the cell's diagnostics to the result,
for the readings that the limits of ``correct`` are set from.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from benchlib import generators, manifest, trace
from benchlib.peaks import PEAKS, peaks_for

FORBIDDEN = ("jax", "jaxlib", "flax", "artist_style_transfer_tpu")


class Window(NamedTuple):
    setup_s: float
    window_s: float
    units: int
    images: int


def smi() -> dict | None:
    """The card's SM clock, power draw and limit, and temperature, or None."""
    q = "clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    vals = out.strip().splitlines()[0].split(", ")
    return dict(zip(("sm_mhz", "power_w", "power_limit_w", "temp_c"), vals))


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device: torch.device,
             t_start: float, threads: int, traffic: dict | None = None,
             readings: bool = False) -> dict:
    """Run ``workload`` once and return its result line (printed by the caller).
    ``traffic`` replaces the cell's traffic file (the CPU tests' small sizes)."""
    m = manifest.manifest()
    cell = manifest.cell(workload, m)
    cfg = manifest.config(cell["config"], m)
    traffic = traffic or manifest.traffic(cell["traffic"])
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peaks = peaks_for(kind) if cuda else PEAKS["H100 SXM"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = generators.load(traffic["generator"]).setup(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    unit_work = state.work(peaks)
    result: dict = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell["chips"]}
    if not trace_on:
        max_units = state.trace_units if readings else traffic["max_units"]
        state.prepare_window(max_units)
        smi0 = smi() if cuda else None
        generators.sync(device)
        t0 = time.perf_counter()
        times, i = [], 0
        while True:
            a = time.perf_counter()
            state.unit(i)
            b = time.perf_counter()
            times.append(b - a)
            i += 1
            if (b - t0 >= seconds and not readings) or i >= max_units:
                break
        generators.sync(device)
        window_s = time.perf_counter() - t0
        smi1 = smi() if cuda else None
        ctx = Window(setup_s, window_s, i, i * state.images_per_unit)
        print(json.dumps({"portbench": "window", "workload": workload, "seed": seed,
                          "units": i, "unit_s": [round(t, 6) for t in times],
                          "threads": threads, "smi_start": smi0, "smi_end": smi1}))
        kind_metrics = "end_to_end"
    else:
        n = state.trace_units
        state.prepare_window(n)
        dev_ev, host_ev, win = trace.profile_units(
            lambda k: [state.unit(j) for j in range(k)], n, lambda: generators.sync(device))
        ctx = trace.summarize(dev_ev, host_ev, win, n, n * state.images_per_unit,
                              n * state.steps_per_unit, unit_work)
        i = n
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.device_ops],
                               "idle_gaps": [list(x) for x in ctx.idle_gaps]}
        kind_metrics = "per_layer"
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    for metric in manifest.metrics_for(workload, kind_metrics, m):
        value = manifest.reader(metric["name"])(ctx)
        if value is not None:
            result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}

    state.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = state.check()
    if readings:
        result.update(control=state.check("control"), diagnostics=state.diagnostics())
    limits = manifest.limits(workload)
    correct = set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in limits)
    result.update(correct=correct, attempted=i, failed=0 if correct else i, device=device_info)
    result["checked"] = {k: {"value": numbers[k], "limit": limits.get(k)} for k in numbers}
    return result


def finish(result: dict) -> int:
    """Print the checked numbers on standard error and the result as the last line of
    standard output; refuse (exit 3, no result) where JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"portbench: refused: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, v in result["checked"].items():
        print(f"portbench: {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

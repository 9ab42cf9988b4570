"""The traced window: a ``torch.profiler`` trace of whole units, reduced to what the
per-layer readers read.

Device events are every event the profiler puts on the CUDA device (kernels, copies and
sets); kernels are the device events that are not copies or sets. ``busy_s`` is the union
of the device events inside the window, which is the host span ``portbench:window``. An
idle gap is a stretch of the window with no device event; it is named by the innermost
host event on the driving thread that covers its middle.
"""

from __future__ import annotations

import re
from typing import NamedTuple

# A conv or GEMM kernel, by name: cuDNN's and cuBLAS's engines, the port's K1 and K2.
# Layout transforms (nchwToNhwc and the like) are not.
CONV_GEMM = re.compile(r"conv|gemm|xmma|fprop|dgrad|wgrad|gram_tile_kernel|qconv_kernel|"
                       r"winograd|fft|cutlass|implicit|wgmma|hmma|imma|s1688|s16816|sm90_|sm80_",
                       re.IGNORECASE)
NOT_CONV = re.compile(r"nchwtonhwc|nhwctonchw|nchw2nhwc|nhwc2nchw|transpose", re.IGNORECASE)
COPY_SET = re.compile(r"^(memcpy|memset)", re.IGNORECASE)
SPAN = "portbench:"  # the prefix of the benchmark's own spans
K1_NAME = "gram_tile_kernel"
K2_NAME = "qconv_kernel"


class Kernel(NamedTuple):
    name: str
    start: float  # seconds, in the host events' clock
    dur: float


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    kernels: list  # [Kernel] inside the window, copies and sets left out
    device_ops: list  # [(name, seconds)] of every device event, most first
    idle_gaps: list  # [(host event name, seconds)], most first
    units: int
    images: int
    steps: int
    work: dict  # the generator's counts for one unit


def is_conv(name: str) -> bool:
    return bool(CONV_GEMM.search(name)) and not NOT_CONV.search(name)


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(host: list[tuple[float, float, str]], points: list[float]) -> list[str]:
    """For each point (sorted), the name of the innermost (latest-starting) host interval
    that covers it; host: properly nested (start, end, name), sorted by start."""
    names, stack, i = [], [], 0
    for x in points:
        while i < len(host) and host[i][0] <= x:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host event)")
    return names


def summarize(device_events, host_events, window: tuple[float, float], units: int, images: int,
              steps: int, work: dict, top: int = 10) -> TraceSummary:
    """device_events: (name, start_s, dur_s); host_events: (name, start_s, end_s) of the
    driving thread; window: (start_s, end_s) of the host span around the units."""
    t0, t1 = window
    inside = [(n, s, d) for n, s, d in device_events if s + d > t0 and s < t1]
    by_name: dict[str, float] = {}
    for n, _, d in inside:
        by_name[n] = by_name.get(n, 0.0) + d
    merged = _merge([(max(s, t0), min(s + d, t1)) for _, s, d in inside])
    busy = sum(b - a for a, b in merged)
    gaps, last = [], t0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    host = sorted((s, e, n) for n, s, e in host_events
                  if e > t0 and s < t1 and not n.startswith("portbench:window"))
    mids = [(a + b) / 2 for a, b in gaps]
    gap_names: dict[str, float] = {}
    for (a, b), name in zip(gaps, _innermost(host, mids)):
        gap_names[name] = gap_names.get(name, 0.0) + (b - a)
    kernels = [Kernel(n, s, d) for n, s, d in inside if not COPY_SET.match(n)]
    return TraceSummary(
        window_s=t1 - t0, busy_s=busy, kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gap_names.items(), key=lambda kv: -kv[1])[:top],
        units=units, images=images, steps=steps, work=work)


def profile_units(run_units, n_units: int, sync):
    """Run ``run_units(n_units)`` under the profiler; return (device events, host events of
    this thread, window) in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with record_function("portbench:window"):
            run_units(n_units)
            sync()
    events = prof.events()
    spans = [ev for ev in events if ev.name == "portbench:window"]
    if not spans:
        raise RuntimeError("the profiler lost the span portbench:window")
    thread = spans[0].thread
    window = (spans[0].time_range.start * 1e-6, spans[0].time_range.end * 1e-6)
    device, host = [], []
    for ev in events:
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type.name == "CUDA":
            # a span's range on the device's timeline is no device work
            if not (getattr(ev, "is_user_annotation", False) or ev.name.startswith(SPAN)):
                device.append((ev.name, start, end - start))
        elif ev.thread == thread and ev.name != "portbench:window":
            host.append((ev.name, start, end))
    return device, host, window


def kernel_count(kernels: list[Kernel], needle: str) -> tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds ``needle``."""
    hits = [k.dur for k in kernels if needle in k.name]
    return len(hits), sum(hits)

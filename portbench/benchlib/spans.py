"""The program's own spans in a traced pass: the ``ast:`` ranges that the port records
(``artist_style_transfer_tpu_torch.utils.trace.span``) while a profiler runs, reduced to
what each step of the program launched on the device and how long the device sat idle
in it.

A device event belongs to the innermost ``ast:`` span on the driving thread that covers
the start of the CUDA runtime call that launched it (the host event named ``cu...`` whose
id is the device event's, its correlation id; on any thread: the autograd engine runs a
CUDA backward on its own). An idle gap of the window belongs to the innermost ``ast:``
span that covers its middle, the rule ``trace.summarize`` names gaps by. A span's
annotation on the device's timeline is no device work. ``busy_s``, the gaps and the device
events are the ones ``trace.summarize`` reads from the same trace.

Read by ``span_readings.py``; the harness's traced pass does not call it.
"""

from __future__ import annotations

from typing import NamedTuple

from benchlib import trace

PREFIX = "ast:"  # the program's spans
NOT_WORK = (trace.SPAN, PREFIX)  # a span's range on the device is no device work


class DeviceEvent(NamedTuple):
    name: str
    start: float  # seconds, in the host events' clock
    dur: float
    link: int  # its correlation id, the id of the runtime call that launched it; 0 for none


class SpanTotals(NamedTuple):
    count: int
    host_s: float
    launches: int
    device_s: float
    idle_s: float


def _innermost(spans: list[tuple[float, float, str]], points: list[float]) -> list[str | None]:
    """For each point (sorted), the name of the innermost span that covers it, or None:
    ``trace._innermost`` over the spans with a parent before a child that starts with it."""
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    return [None if n == "(no host event)" else n for n in trace._innermost(ordered, points)]


def reduce(device: list[DeviceEvent], launch_starts: dict[int, float],
           spans: list[tuple[str, float, float]], window: tuple[float, float]) -> dict:
    """{span name: SpanTotals} over the window. device: every device event of the trace
    (annotations included, as the profiler gives them); launch_starts: {runtime call's
    id: start}; spans: (name, start, end) of the ``ast:`` spans of the driving thread."""
    t0, t1 = window
    inside = [e for e in device if e.start + e.dur > t0 and e.start < t1
              and not e.name.startswith(NOT_WORK)]
    ranges = [(s, e, n) for n, s, e in spans if e > t0 and s < t1]
    totals = {n: [0, 0.0, 0, 0.0, 0.0] for _, _, n in ranges}
    for s, e, n in ranges:
        totals[n][0] += 1
        totals[n][1] += e - s
    launched = sorted((launch_starts[e.link], e.dur) for e in inside
                      if e.link and e.link in launch_starts)
    for (_, dur), name in zip(launched, _innermost(ranges, [x for x, _ in launched])):
        if name is not None:
            totals[name][2] += 1
            totals[name][3] += dur
    merged = trace._merge([(max(e.start, t0), min(e.start + e.dur, t1)) for e in inside])
    gaps, last = [], t0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    for (a, b), name in zip(gaps, _innermost(ranges, [(a + b) / 2 for a, b in gaps])):
        if name is not None:
            totals[name][4] += b - a
    return {n: SpanTotals(*v) for n, v in sorted(totals.items())}


def profile_units(run_units, n_units: int, sync):
    """``trace.profile_units``'s (device events, host events, window) of one traced pass,
    and the reduction of its ``ast:`` spans (:func:`reduce`)."""
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
    marks = [ev for ev in events if ev.name == "portbench:window"]
    if not marks:
        raise RuntimeError("the profiler lost the span portbench:window")
    thread = marks[0].thread
    window = (marks[0].time_range.start * 1e-6, marks[0].time_range.end * 1e-6)
    device, host, linked, launch_starts, spans = [], [], [], {}, []
    for ev in events:
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type.name == "CUDA":
            if getattr(ev, "is_user_annotation", False):
                continue
            linked.append(DeviceEvent(ev.name, start, end - start, ev.id))
            if not ev.name.startswith(trace.SPAN):  # as trace.profile_units keeps them
                device.append((ev.name, start, end - start))
            continue
        if ev.name.startswith("cu"):  # a CUDA API call: its id is its launches' correlation id
            launch_starts[ev.id] = start
        if ev.thread == thread and ev.name != "portbench:window":
            host.append((ev.name, start, end))
            if ev.name.startswith(PREFIX):
                spans.append((ev.name, start, end))
    return device, host, window, reduce(linked, launch_starts, spans, window)


def _counted(totals: dict, name: str, count: int) -> SpanTotals | None:
    """The totals of span ``name``, where the trace holds ``count`` (> 0) of them."""
    span = totals.get(name)
    return span if count > 0 and span is not None and span.count == count else None


def staging_idle_ms_per_batch(totals: dict, batches: int) -> float | None:
    """Idle ms a batch under the eval's staging and its host-to-device copy."""
    stage = _counted(totals, "ast:eval.stage", batches)
    h2d = _counted(totals, "ast:eval.h2d", batches)
    return None if stage is None or h2d is None else 1e3 * (stage.idle_s + h2d.idle_s) / batches


def quantize_ms_per_call(totals: dict, calls: int) -> float | None:
    """Device ms launched under the eval's per-call quantization, plus its idle ms, a call."""
    q = _counted(totals, "ast:eval.quantize", calls)
    return None if q is None else 1e3 * (q.device_s + q.idle_s) / calls


def update_ms_per_step(totals: dict, steps: int) -> float | None:
    """Device ms launched under the training update, plus its idle ms, a step."""
    update = _counted(totals, "ast:train.update", steps)
    if update is None or _counted(totals, "ast:train.step", steps) is None:
        return None
    return 1e3 * (update.device_s + update.idle_s) / steps

"""The reduction of the program's ``ast:`` spans (``benchlib.spans``): on made-up events,
on small cells on the CPU, and, with ``-m cuda``, on a real trace of the card."""

from __future__ import annotations

import pytest
import torch

import span_readings
from benchlib import spans, trace
from benchlib.spans import DeviceEvent
from test_portbench_runs import CELLS, SEED, _traffic

# ast:train.step 0-3 holds ast:train.update 2-3; the window is 0-4.
SPANS = [("ast:train.step", 0.0, 3.0), ("ast:train.update", 2.0, 3.0)]
LAUNCHES = {11: 0.1, 12: 2.1, 13: 2.9, 14: 3.6}  # runtime call id: start
DEVICE = [DeviceEvent("gemm", 0.5, 1.0, 11),  # launched in the step, outside the update
          DeviceEvent("adam", 2.2, 0.2, 12),  # launched in the update
          DeviceEvent("copy", 3.5, 0.5, 13),  # launched in the update, runs after it
          DeviceEvent("tail", 3.9, 0.05, 14),  # launched outside every span
          DeviceEvent("unlinked", 0.0, 0.1, 0)]


def test_device_events_go_to_the_launching_span():
    totals = spans.reduce(DEVICE, LAUNCHES, SPANS, (0.0, 4.0))
    step, update = totals["ast:train.step"], totals["ast:train.update"]
    assert (step.count, update.count) == (1, 1)
    assert (step.host_s, update.host_s) == pytest.approx((3.0, 1.0))
    assert (step.launches, update.launches) == (1, 2)
    assert (step.device_s, update.device_s) == pytest.approx((1.0, 0.7))


def test_idle_goes_to_the_innermost_span():
    totals = spans.reduce(DEVICE, LAUNCHES, SPANS, (0.0, 4.0))
    # busy: 0-0.1, 0.5-1.5, 2.2-2.4, 3.5-4.0; gaps 0.1-0.5 and 1.5-2.2 in the step alone,
    # 2.4-3.5 (middle 2.95) in the update
    assert totals["ast:train.step"].idle_s == pytest.approx(0.4 + 0.7)
    assert totals["ast:train.update"].idle_s == pytest.approx(1.1)


def test_a_span_that_starts_with_its_parent_is_innermost():
    nested = [("ast:eval.logits", 1.0, 2.0), ("ast:eval.call", 1.0, 3.0)]
    device = [DeviceEvent("k", 1.9, 0.2, 7), DeviceEvent("j", 2.5, 0.5, 8)]
    totals = spans.reduce(device, {7: 1.0, 8: 2.2}, nested, (1.0, 3.0))
    assert totals["ast:eval.logits"].launches == 1 and totals["ast:eval.call"].launches == 1
    assert totals["ast:eval.logits"].idle_s == pytest.approx(0.9)  # 1.0-1.9
    assert totals["ast:eval.call"].idle_s == pytest.approx(0.4)  # 2.1-2.5


def test_annotations_are_no_device_work():
    annotations = [DeviceEvent("ast:train.step", 0.0, 3.0, 0),
                   DeviceEvent("ast:train.update", 2.0, 1.0, 12),
                   DeviceEvent("portbench:unit", 0.0, 4.0, 0)]
    plain = spans.reduce(DEVICE, LAUNCHES, SPANS, (0.0, 4.0))
    assert spans.reduce(DEVICE + annotations, LAUNCHES, SPANS, (0.0, 4.0)) == plain


def test_readings_need_the_cells_span_count():
    totals = {"ast:eval.stage": spans.SpanTotals(4, 0.1, 0, 0.0, 0.02),
              "ast:eval.h2d": spans.SpanTotals(4, 0.1, 4, 0.01, 0.006),
              "ast:eval.quantize": spans.SpanTotals(1, 0.2, 90, 0.05, 0.03),
              "ast:train.step": spans.SpanTotals(4, 1.0, 400, 0.9, 0.04),
              "ast:train.update": spans.SpanTotals(4, 0.01, 40, 0.002, 0.001)}
    assert spans.staging_idle_ms_per_batch(totals, 4) == pytest.approx(1e3 * 0.026 / 4)
    assert spans.quantize_ms_per_call(totals, 1) == pytest.approx(1e3 * 0.08)
    assert spans.update_ms_per_step(totals, 4) == pytest.approx(1e3 * 0.003 / 4)
    assert spans.staging_idle_ms_per_batch(totals, 5) is None
    assert spans.quantize_ms_per_call(totals, 2) is None
    assert spans.update_ms_per_step(totals, 3) is None
    assert spans.update_ms_per_step({**totals, "ast:train.step": totals["ast:eval.quantize"]},
                                    4) is None
    assert spans.staging_idle_ms_per_batch({}, 4) is None
    assert spans.quantize_ms_per_call({}, 0) is None


@pytest.mark.parametrize("cell", CELLS)
def test_small_cells_read_their_spans(cell):
    line = span_readings.read(cell, SEED, torch.device("cpu"), _traffic(cell))
    readings = {k for k, v in line["readings"].items() if v is not None}
    generator = _traffic(cell)["generator"]
    want = {"evaluate": {"staging_idle_ms_per_batch"}, "train_cycle": {"update_ms_per_step"},
            "stylize": set()}[generator]
    if generator == "evaluate" and "int8" in cell:
        want = want | {"quantize_ms_per_call"}
    assert readings == want
    assert line["ast_on_device"] == 0 and line["busy_s"] == 0  # no device on the CPU


@pytest.mark.cuda
def test_a_traced_span_leaves_busy_unchanged(cuda_device):
    from artist_style_transfer_tpu_torch.utils.trace import span

    x = torch.randn(1024, 1024, device=cuda_device)

    def work(k):
        for _ in range(k):
            with span("test.matmul"):
                x @ x

    sync = lambda: torch.cuda.synchronize(cuda_device)  # noqa: E731
    device, host, window = trace.profile_units(work, 8, sync)
    assert not [name for name, _, _ in device if name.startswith(spans.PREFIX)]
    assert any(name == "ast:test.matmul" for name, _, _ in host)
    # the harness's busy time, with and without every event a span could have left
    t = trace.summarize(device, host, window, 1, 1, 1, {})
    real = [e for e in device if not e[0].startswith(spans.NOT_WORK)]
    assert t.busy_s == trace.summarize(real, host, window, 1, 1, 1, {}).busy_s > 0
    *_, totals = spans.profile_units(work, 8, sync)
    matmul = totals["ast:test.matmul"]
    assert matmul.count == 8 and matmul.launches >= 8 and matmul.device_s > 0

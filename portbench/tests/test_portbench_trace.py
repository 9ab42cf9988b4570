"""The reduction of a trace to the per-layer readings, on made-up events."""

from __future__ import annotations

import pytest

from benchlib import readers, trace


def _summary(work=None):
    device = [("void qconv_kernel<128, 64, true>(Params, int)", 1.0, 0.5),
              ("void at::native::elementwise_kernel<128, 2>", 1.6, 0.2),
              ("Memcpy HtoD (Pageable -> Device)", 2.0, 0.5),
              ("void cudnn::ops::nchwToNhwcKernel<float>", 3.0, 0.25),
              ("sm90_xmma_fprop_implicit_gemm_f32f32", 3.5, 0.5),
              ("outside", 10.0, 1.0)]
    host = [("portbench:evaluate_with_classifier", 0.9, 4.2),
            ("aten::copy_", 1.5, 1.6), ("cudaStreamSynchronize", 2.5, 2.99)]
    return trace.summarize(device, host, (1.0, 4.0), units=2, images=8, steps=4,
                           work=work or {"least_s": 0.3, "k2_bound_s": 0.25, "k2_launches": 0.5})


def test_busy_gaps_and_names():
    t = _summary()
    assert t.window_s == pytest.approx(3.0)
    assert t.busy_s == pytest.approx(0.5 + 0.2 + 0.5 + 0.25 + 0.5)
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(0.1)  # the gap 1.5-1.6
    assert gaps["portbench:evaluate_with_classifier"] == pytest.approx(0.45)  # 1.8-2, 3.25-3.5
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.5)
    assert len(t.kernels) == 4  # the copy is a device op, not a kernel; "outside" is outside
    assert t.device_ops[0][1] == pytest.approx(0.5)


def test_readers():
    t = _summary()
    assert readers.idle_share(t) == pytest.approx(100 * (1 - 1.95 / 3.0))
    assert readers.mfu(t) == pytest.approx(100 * 0.3 * 2 / 3.0)
    assert readers.launches_per_step(t) == pytest.approx(1.0)
    assert readers.conv_ms_per_step(t) == pytest.approx(1e3 * (0.5 + 0.5) / 4)
    assert readers.nonconv_ms_per_image(t) == pytest.approx(1e3 * (0.2 + 0.25) / 8)
    # one K2 launch in the trace, one expected (0.5 a unit over 2 units)
    assert readers.k2_roofline(t) == pytest.approx(100 * 0.25 * 2 / 0.5)
    assert readers.k1_roofline(t) is None  # no K1 in this cell: nothing to read


def test_missing_launches_read_nothing():
    t = _summary({"least_s": 0.3, "k2_bound_s": 0.25, "k2_launches": 3})
    assert readers.k2_roofline(t) is None
    empty = trace.summarize([], [], (0.0, 1.0), 1, 1, 1, {})
    assert readers.idle_share(empty) is None and readers.mfu(empty) is None
    assert readers.launches_per_step(empty) is None


def test_conv_names():
    assert trace.is_conv("void gram_tile_kernel<float, 64>(float const*)")
    assert trace.is_conv("sm90_xmma_wgrad_implicit_gemm_indexed_f32f32_tf32f32")
    assert not trace.is_conv("void cudnn::ops::nchwToNhwcKernel<float, float, float, false>")
    assert not trace.is_conv("void at::native::reduce_kernel<512, 1>")

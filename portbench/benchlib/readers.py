"""The formulas of the metric readers under ``metrics/``. A reader returns None where it
finds nothing to read, and the metric is then left out of the result line."""

from __future__ import annotations

from benchlib.trace import K1_NAME, K2_NAME, is_conv, kernel_count


def images_per_s(w) -> float:
    """The window's images over its seconds (end to end, host clock)."""
    return w.images / w.window_s


def setup_s(w) -> float:
    return w.setup_s


def idle_share(t) -> float | None:
    """% of the traced window in which no operation ran on the device."""
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(t) -> float | None:
    """% of the chip's peak: the least time of the units' operations, each at its
    precision's peak, over the traced window."""
    least = t.work.get("least_s")
    return None if not least else 100.0 * least * t.units / t.window_s


def launches_per_step(t) -> float | None:
    return len(t.kernels) / t.steps if t.kernels else None


def conv_ms_per_step(t) -> float | None:
    ms = 1e3 * sum(k.dur for k in t.kernels if is_conv(k.name))
    return ms / t.steps if ms else None


def nonconv_ms_per_image(t) -> float | None:
    ms = 1e3 * sum(k.dur for k in t.kernels if not is_conv(k.name))
    return ms / t.images if ms else None


def _roofline(t, name: str, prefix: str) -> float | None:
    """% of a kernel's roofline: its launches' least time over their device time, read
    only where the trace holds every launch the units make."""
    launches, seconds = kernel_count(t.kernels, name)
    expected = t.work.get(f"{prefix}_launches", 0) * t.units
    if not expected or launches != expected or seconds <= 0:
        return None
    return 100.0 * t.work[f"{prefix}_bound_s"] * t.units / seconds


def k1_roofline(t) -> float | None:
    return _roofline(t, K1_NAME, "k1")


def k2_roofline(t) -> float | None:
    return _roofline(t, K2_NAME, "k2")

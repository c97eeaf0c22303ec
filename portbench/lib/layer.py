"""Arithmetic shared by the per-layer metric readers. A reader that finds
nothing to read returns None, and the metric is left out of the line; a
share of a roofline or of a peak is never reported as 0 for want of
data."""

from __future__ import annotations

from portbench.lib import flops, peaks


def span_ms(data, name, unit):
    """Milliseconds in spans ``name`` per ``unit`` span of the window."""
    spans = data.get("spans")
    return None if spans is None else spans.per_unit_ms(name, unit)


def idle_share(data):
    tr = data.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernels_per_unit(data):
    tr = data.get("trace")
    if tr is None or tr.n_kernels == 0:
        return None
    return tr.n_kernels / tr.units


def kde_roofline(data):
    """The KDE kernel's share of its roofline over the profiled window:
    the least time its launches could take (each the larger of its
    operations over the float32 peak and its bytes over the memory
    bandwidth) over the device time the trace gives it by name."""
    tr, shapes = data.get("trace"), data.get("kde_shapes")
    if tr is None or not shapes:
        return None
    n, secs = tr.durations("kde_loglik")
    if n != len(shapes) or secs <= 0:
        return None
    bound = sum(max(flops.kde_flops(*s) / peaks.FP32_FLOPS,
                    flops.kde_bytes(*s) / peaks.HBM_BYTES_PER_S)
                for s in shapes)
    return 100.0 * bound / secs


def step_mfu(data):
    """Counted operations of a unit of work over (its time x the float32
    peak): the whole step's share of the chip's peak."""
    step_ms, work = data.get("step_ms"), data.get("step_flops")
    if not step_ms or not work:
        return None
    return 100.0 * work / (step_ms / 1e3 * peaks.FP32_FLOPS)


def window_mfu(data):
    """The window's counted operations over (its time x the peak)."""
    secs, work = data.get("window_s"), data.get("window_flops")
    if not secs or not work:
        return None
    return 100.0 * work / (secs * peaks.FP32_FLOPS)

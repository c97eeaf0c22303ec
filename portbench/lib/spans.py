"""Spans from the benchmark's own files, around calls into the port.

With tracing off a span costs a flag test. With tracing on it ends in a
device sync, so its host-clock duration holds the device work it started,
and it opens a ``torch.profiler.record_function`` range of its name, so a
profiled window can name what the host was doing in a device idle gap.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, enabled: bool, device=None):
        self.enabled = bool(enabled)
        self.device = torch.device(device) if device is not None else None
        self.times = defaultdict(list)      # name -> [seconds]
        self.keep_times = True              # off while a window is profiled

    def sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function("portbench." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                if self.keep_times:
                    self.times[name].append(time.perf_counter() - t0)

    def per_unit_ms(self, name: str, unit: str):
        """Milliseconds in spans ``name`` per span ``unit`` (a step, a
        tick), or None when either never ran."""
        xs, units = self.times.get(name), self.times.get(unit)
        return 1e3 * sum(xs) / len(units) if xs and units else None


def wrap(module, name: str, wrapper):
    """Replace ``module.name`` by ``wrapper(original)``; returns the
    restorer. Calls into the port look their callee up on its module at
    call time, so a wrapped attribute sees every call."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    return lambda: setattr(module, name, orig)


def spanned(spans: Spans, span_name: str):
    """A ``wrap`` wrapper that runs the call inside a span."""
    def wrapper(fn):
        def inner(*args, **kwargs):
            with spans.span(span_name):
                return fn(*args, **kwargs)
        return inner
    return wrapper

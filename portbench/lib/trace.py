"""Reduction of a ``torch.profiler`` trace to device metrics.

The busy time is the union of the device activities' intervals: a sum of
their durations counts overlapping kernels twice. The idle share is taken
over the traced window, the host-clock length of the profiled work,
which ends in a device sync. Events are read from the raw trace
(``kineto_results.events()``): building torch.profiler's Python tree
(``key_averages``) for ~10^6 events takes minutes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

PREFIX = "portbench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float            # host-clock length of the profiled work
    busy_s: float              # union of device intervals
    units: int                 # units of work (steps, ticks) profiled
    n_kernels: int             # kernel launches among them
    by_name: dict              # name -> [count, seconds]
    idle_gaps: list            # [(name, seconds)], the longest first

    def top_ops(self, n=10):
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, secs] for name, (_, secs) in ops]

    def durations(self, substring: str):
        """(count, seconds) of the device ops whose name holds substring."""
        n = s = 0
        for name, (c, secs) in self.by_name.items():
            if substring in name:
                n += c
                s += secs
        return n, s


def _start_ns(e):
    try:
        return e.start_ns()
    except AttributeError:
        return int(e.start_us() * 1000)


def _annotation(e, name):
    """A range that a ``record_function`` mirrors onto the device's
    timeline: no device work, and it would cover the whole span."""
    if name.startswith(PREFIX):
        return True
    if getattr(e, "is_user_annotation", None) is not None and \
            e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind())


def _union(starts, ends):
    """Merged intervals of (starts, ends) arrays: (merged starts, ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    m_starts = s[idx]
    m_ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return m_starts, m_ends


def reduce(prof, window_s: float, units: int,
           n_gaps: int = 10) -> TraceSummary:
    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, names = [], [], []
    ann = []                    # (start, end, name) of portbench ranges
    cpu_ops = []                # (start, end, name) of host ops
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = _start_ns(e)
        d = e.duration_ns()
        if e.device_type() == cuda:
            if _annotation(e, name):
                continue
            dev_s.append(s)
            dev_e.append(s + d)
            names.append(name)
        elif name.startswith(PREFIX):
            ann.append((s, s + d, name[len(PREFIX):]))
        elif name.startswith("aten::") or name.startswith("cuda"):
            cpu_ops.append((s, s + d, name))
    by_name = defaultdict(lambda: [0, 0.0])
    for name, s, e in zip(names, dev_s, dev_e):
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    n_kernels = sum(c for name, (c, _) in by_name.items()
                    if not name.startswith("Memcpy")
                    and not name.startswith("Memset"))
    if not dev_s:
        return TraceSummary(window_s, 0.0, units, 0, {}, [])
    starts = np.asarray(dev_s, np.int64)
    ends = np.asarray(dev_e, np.int64)
    m_s, m_e = _union(starts, ends)
    busy_s = float((m_e - m_s).sum()) / 1e9
    gaps = m_s[1:] - m_e[:-1]
    order = np.argsort(-gaps)[:n_gaps]
    idle = []
    if len(ann) or len(cpu_ops):
        a = np.asarray([(s, e) for s, e, _ in ann], np.int64).reshape(-1, 2)
        c = np.asarray([(s, e) for s, e, _ in cpu_ops],
                       np.int64).reshape(-1, 2)
    for i in order:
        mid = (m_e[i] + m_s[i + 1]) // 2
        label = []
        if len(ann):
            inside = np.flatnonzero((a[:, 0] <= mid) & (a[:, 1] >= mid))
            if len(inside):
                # the innermost range: the latest to start
                label.append(ann[inside[np.argmax(a[inside, 0])]][2])
        if len(cpu_ops):
            inside = np.flatnonzero((c[:, 0] <= mid) & (c[:, 1] >= mid))
            if len(inside):
                label.append(cpu_ops[inside[np.argmax(c[inside, 0])]][2])
        idle.append((" | ".join(label) or "host", float(gaps[i]) / 1e9))
    return TraceSummary(window_s, busy_s, units, n_kernels, dict(by_name),
                        idle)


def profile(fn, units: int, sync) -> TraceSummary:
    """Run ``fn()`` (``units`` units of work) under torch.profiler with
    host and device activities; the traced window ends in ``sync()``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    return reduce(prof, window_s, units)

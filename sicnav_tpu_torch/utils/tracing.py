"""Spans and counters inside the port, off by default.

A span is a named stretch of host time: ``with tracing.span("ipm.kkt"):``.
It records its name, its start and end, the span it opened inside and
the control step it belongs to. A span named in ``UNITS`` ("control",
"tick") that opens outside any other span starts a new step; spans
opened after it, up to the next such span, belong to that step (the
env step after a control step too).

Counters are kept against the innermost open span, and so per span and
per step:

- ``count(name, value)`` from the program: ``solves`` and
  ``solves_accepted`` at the control entry points (the accepted share is
  a device tensor, kept as it is and read once, in ``snapshot()``);
  ``graph_captures``, ``graph_replays`` (``utils.cuda_graph``) and
  ``graph_eager`` (a batched controller call run eagerly, off a card) in
  ``mpc/sicnav_diffusion.act_on_forecasts_batch``;
- ``host_syncs``: while the tracer is on for a CUDA device, torch's sync
  debug mode is "warn" and each of its warnings counts one against the
  innermost open span, instead of being shown (``Snapshot.sync_sites``
  counts them by the source line that synced);
- ``device_alloc`` / ``device_free``: the caching allocator's own
  ``cudaMalloc`` / ``cudaFree`` calls (``torch.cuda.memory_stats``'s
  ``num_device_alloc`` / ``num_device_free``), read at each span's start
  and end and kept as each span's own share (its calls less those of the
  spans inside it).

Switching: ``enable(device)``, ``disable()`` (restores the sync debug
mode and the warning hooks; what was recorded stays for ``snapshot()``),
``reset()`` (drops what was recorded) and ``snapshot()``. With the tracer
off, ``span()`` returns one shared no-op object and ``count()`` tests a
flag: nothing is allocated and no clock is read.

The tracer never syncs the device and opens no ``record_function``
range, so it adds nothing to a profiler's device timeline. It stamps
spans with ``time.perf_counter_ns``; ``snapshot()`` measures the offset
to the wall clock that ``torch.profiler`` stamps its events with and
returns every span on that clock, so a span lies directly on a profile's
timeline. The tracer's own reads fall outside the spans they time (in the
enclosing span's own time). Spans come from one thread, the one that runs
the control step.

Operators: ``enable(device)`` before the work, ``snapshot()`` after it;
``Snapshot.ms_per_unit``, ``total`` and ``first`` give per-step times,
counter totals and the first step's time.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
import warnings
from collections import Counter
from typing import NamedTuple, Optional

import torch

UNITS = ("control", "tick")
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_on = False
_st = None          # the _State of the current recording


class Span(NamedTuple):
    name: str
    start_ns: int       # on the profiler's clock (snapshot) or perf_counter
    end_ns: int
    parent: int         # index of the enclosing span, -1 at the root
    step: int           # the control step or tick, -1 before the first


class Count(NamedTuple):
    name: str
    span: int           # the innermost open span, -1 outside any
    step: int
    value: float


class _State:
    def __init__(self, device):
        self.device = device
        self.spans = []         # [name, t0, t1, parent, step, alloc0, alloc1]
        self.stack = []
        self.step = -1
        self.counts = []        # [name, span, step, value]
        self.sites = Counter()  # "file:line" -> host syncs

    def here(self):
        return self.stack[-1] if self.stack else -1


class _Null:
    """The span of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, t_ns):
        pass


NULL = _Null()


def _alloc_calls(device):
    """(cudaMalloc, cudaFree) calls of the caching allocator so far, or
    None off a card."""
    if device is None or device.type != "cuda":
        return None
    s = torch.cuda.memory_stats_as_nested_dict(device)
    return s["num_device_alloc"], s["num_device_free"]


class _Span:
    __slots__ = ("name", "t0", "t1", "i")

    def __init__(self, name, t0):
        self.name, self.t0, self.t1 = name, t0, None

    def __enter__(self):
        st = _st
        parent = st.here()
        if parent < 0 and self.name in UNITS:
            st.step += 1
        # the tracer's own reads lie outside the span: the allocator's
        # statistics before the start, after the end
        alloc = _alloc_calls(st.device)
        t0 = time.perf_counter_ns() if self.t0 is None else self.t0
        self.i = len(st.spans)
        st.spans.append([self.name, t0, None, parent, st.step, alloc, None])
        st.stack.append(self.i)
        return self

    def end(self, t_ns):
        """Close at ``t_ns`` (a ``perf_counter_ns`` reading) in place of a
        clock read at the end of the ``with`` block."""
        self.t1 = t_ns

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns() if self.t1 is None else self.t1
        st = _st
        rec = st.spans[self.i]
        rec[2] = t1
        rec[6] = _alloc_calls(st.device)
        # spans left open inside this one (an exception) close with it
        while st.stack and st.stack.pop() != self.i:
            pass
        return False


def span(name: str, start_ns: int = None):
    """A context manager that records a span ``name``; ``start_ns`` (a
    ``perf_counter_ns`` reading) replaces the clock read at its start, and
    ``.end(t_ns)`` the one at its end, where the caller times the same
    stretch itself."""
    if not _on:
        return NULL
    return _Span(name, start_ns)


def spanned(name: str):
    """A decorator: every call of the function runs inside span
    ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return inner
    return deco


def count(name: str, value=1):
    """Add ``value`` (a number or a device tensor, summed at the snapshot)
    to counter ``name`` in the innermost open span."""
    if _on:
        _st.counts.append([name, _st.here(), _st.step, value])


# -- the sync debug mode's warnings -------------------------------------

_saved = None       # (sync debug mode, showwarning, filter) while on


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    if _on and str(message).startswith(SYNC_MESSAGE):
        _st.counts.append(["host_syncs", _st.here(), _st.step, 1])
        _st.sites[_site(filename, lineno)] += 1
        return
    show = _saved[1] if _saved else warnings._showwarning_orig
    show(message, category, filename, lineno, file, line)


def _site(filename, lineno):
    parts = os.path.normpath(filename).split(os.sep)
    if "sicnav_tpu_torch" in parts:
        parts = parts[parts.index("sicnav_tpu_torch"):]
    else:
        parts = parts[-1:]
    return f"{'/'.join(parts)}:{lineno}"


def enable(device=None):
    """Start recording afresh; on a CUDA ``device`` also count host syncs
    and the allocator's calls."""
    global _on, _st, _saved
    if _on:
        disable()
    device = torch.device(device) if device is not None else None
    _st = _State(device)
    mode = None
    if device is not None and device.type == "cuda":
        # the allocator's statistics are empty until CUDA is initialised
        torch.cuda.init()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    _saved = (mode, warnings.showwarning, warnings.filters[0])
    warnings.showwarning = _showwarning
    _on = True


def disable():
    """Stop recording; what was recorded stays for ``snapshot()``."""
    global _on, _saved
    if not _on:
        return
    _on = False
    mode, show, flt = _saved
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    if warnings.showwarning is _showwarning:
        warnings.showwarning = show
    if flt in warnings.filters:
        warnings.filters.remove(flt)
        warnings._filters_mutated()
    _saved = None


def enabled() -> bool:
    return _on


def reset():
    """Drop what was recorded; the step count starts again."""
    if _st is None:
        return
    if _st.stack:
        raise RuntimeError("tracing.reset() inside an open span")
    _st.__init__(_st.device)


def clock_offset_ns(tries: int = 16) -> int:
    """The wall clock (``time.time_ns``, on which ``torch.profiler`` stamps
    its events) less ``perf_counter_ns``, from the tightest of ``tries``
    bracketed readings."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def snapshot() -> "Snapshot":
    """What was recorded since ``enable()`` or ``reset()``, with every span
    on the profiler's clock and the device-side counters read once."""
    if _st is None:
        return Snapshot([], [], clock_offset_ns(), {})
    if _st.stack:
        raise RuntimeError("tracing.snapshot() inside an open span")
    global _on
    off = clock_offset_ns()
    spans = [Span(n, t0 + off, (t0 if t1 is None else t1) + off, p, s)
             for n, t0, t1, p, s, _, _ in _st.spans]
    counts = [list(c) for c in _st.counts]
    lazy = [c for c in counts if torch.is_tensor(c[3])]
    if lazy:
        # the snapshot's own read is not the program's sync
        was, _on = _on, False
        try:
            vals = torch.stack([c[3].detach().to(torch.float64).sum()
                                for c in lazy]).cpu().tolist()
        finally:
            _on = was
        for c, v in zip(lazy, vals):
            c[3] = v
    # the allocator's calls, each span's own
    own = {}
    for i, rec in enumerate(_st.spans):
        a0, a1 = rec[5], rec[6]
        if a0 is None or a1 is None:
            continue
        d = (a1[0] - a0[0], a1[1] - a0[1])
        o = own.get(i, (0, 0))
        own[i] = (o[0] + d[0], o[1] + d[1])
        p = rec[3]
        if p >= 0:
            q = own.get(p, (0, 0))
            own[p] = (q[0] - d[0], q[1] - d[1])
    for i, (n_alloc, n_free) in sorted(own.items()):
        step = _st.spans[i][4]
        if n_alloc:
            counts.append(["device_alloc", i, step, n_alloc])
        if n_free:
            counts.append(["device_free", i, step, n_free])
    return Snapshot(spans, [Count(*c) for c in counts], off,
                    dict(_st.sites.most_common()))


@dataclasses.dataclass
class Snapshot:
    spans: list             # [Span], on the profiler's clock
    counts: list            # [Count], every value a number
    clock_offset_ns: int    # profiler clock = perf_counter_ns + this
    sync_sites: dict        # "file:line" -> host syncs, most first

    def self_ns(self) -> list:
        """Each span's own time: its length less its children's."""
        own = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                own[s.parent] -= s.end_ns - s.start_ns
        return own

    def under(self, i: int, name: str) -> bool:
        """Whether span ``i`` is a span ``name`` or lies inside one."""
        while i >= 0:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def units(self, unit: str) -> int:
        return sum(s.name == unit for s in self.spans)

    def ms_per_unit(self, names, unit: str) -> Optional[float]:
        """Own time of the spans ``names`` per span ``unit``, in ms, or None
        when either never ran."""
        names = {names} if isinstance(names, str) else set(names)
        n = self.units(unit)
        own = self.self_ns()
        hits = [t for s, t in zip(self.spans, own) if s.name in names]
        if not n or not hits:
            return None
        return sum(hits) / 1e6 / n

    def total(self, counter: str, under: str = None) -> float:
        """Counter ``counter`` summed, only inside spans ``under`` if
        given."""
        return sum(c.value for c in self.counts if c.name == counter and
                   (under is None or self.under(c.span, under)))

    def first(self, name: str) -> Optional[Span]:
        return next((s for s in self.spans if s.name == name), None)

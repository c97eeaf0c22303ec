"""The program's own spans and counters, read from its tracer's snapshots
(``sicnav_tpu_torch.utils.tracing``), and joined with a profiled window.

A snapshot holds spans on the profiler's clock, each with its parent and
its step, and counters kept against the innermost open span. The unit of
work is the span a cell's step is made of: ``control`` (a batched step of
the eval loop) or ``tick`` (one tick of the streaming controller).

- ``metrics(setup, window, suffix)``: the per-layer numbers of a cell, by
  the names the benchmark gives them;
- ``join(prof, snap)``: each kernel attributed to the program
  span in which its launch ran (by the runtime call's correlation id),
  and the profiled window's longest device idle gaps labelled with the
  benchmark's range, the innermost program span, the innermost aten op
  and the CUDA runtime call the host was in.

Nothing here imports the program: a snapshot is read through its own
methods (``ms_per_unit``, ``total``, ``units``, ``first``).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from portbench.lib import trace

UNIT = {"eval": "control", "robot": "tick"}
# the spans whose host syncs a step counts: the controller, and in eval
# the env step beside it; a tick holds everything it does
SYNC_SPANS = {"eval": ("control", "env.step"), "robot": ("tick",)}
PHASES = {"ipm_jac_ms": ("ipm.grad", "ipm.jac"),
          "ipm_hess_ms": ("ipm.hess", "ipm.precond"),
          "ipm_kkt_ms": ("ipm.kkt",),
          "ipm_search_ms": ("ipm.search",)}
MPC_PARTS = ("mpc.problem", "mpc.guess", "mpc.solve", "mpc.cascade",
             "ipm.precond", "ipm.grad", "ipm.jac", "ipm.hess", "ipm.kkt",
             "ipm.search")


def metrics(setup, window, suffix: str) -> dict:
    """{metric name: value} of a cell (``suffix`` "eval" or "robot") from
    the set-up snapshot (its first unit is the cold first step) and the
    window's; a number with nothing to read is left out."""
    unit = UNIT[suffix]
    out = {}
    n = window.units(unit) if window is not None else 0
    if n:
        for name, spans in PHASES.items():
            out[name] = window.ms_per_unit(spans, unit)
        solves = window.total("solves")
        if solves:
            out["solve_accept_share"] = \
                100.0 * window.total("solves_accepted") / solves
        out["host_syncs_per_step"] = sum(
            window.total("host_syncs", under=s)
            for s in SYNC_SPANS[suffix]) / n
        out["alloc_calls_per_step"] = (
            window.total("device_alloc", under="control") +
            window.total("device_free", under="control")) / n
    first = setup.first(unit) if setup is not None else None
    if first is not None:
        out["first_step_s"] = (first.end_ns - first.start_ns) / 1e9
    return {f"{k}.{suffix}": v for k, v in out.items() if v is not None}


def mpc_parts_ms(window, suffix: str):
    """The controller by the program's spans, in ms a unit: (the program's
    ``mpc`` spans, the own times of the parts under them), or None."""
    unit = UNIT[suffix]
    n = window.units(unit)
    if not n or window.first("mpc") is None:
        return None
    mpc = sum(s.end_ns - s.start_ns for s in window.spans
              if s.name == "mpc") / 1e6 / n
    return mpc, window.ms_per_unit(MPC_PARTS, unit)


def timeline(spans):
    """The innermost span at each time, as breakpoints and the span index
    that holds from each (-1: none). Spans from one thread nest."""
    if not spans:
        return np.zeros(1, np.int64), np.full(1, -1)
    marks = []
    for i, s in enumerate(spans):
        marks.append((s.start_ns, 1, i))
        marks.append((s.end_ns, 0, i))
    marks.sort()
    stack, bounds, labels = [], [], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        bounds.append(t)
        labels.append(stack[-1] if stack else -1)
    return np.asarray(bounds, np.int64), np.asarray(labels)


def innermost(tl, times):
    """The innermost span index at each of ``times`` (-1: none)."""
    bounds, labels = tl
    idx = np.searchsorted(bounds, np.asarray(times, np.int64),
                          side="right") - 1
    return np.where(idx >= 0, labels[np.clip(idx, 0, None)], -1)


def join(prof, snap, n_gaps: int = 10) -> dict:
    """Kernels by the program span their launch ran in, and the longest
    device idle gaps of the profiled window labelled ``benchmark range |
    program span | aten op | runtime call`` (each where there is one),
    from one pass over the raw trace."""
    cuda = torch.autograd.DeviceType.CUDA
    tl = timeline(snap.spans)
    names = [s.name for s in snap.spans]
    launch_at = {}              # correlation id -> host time of the call
    dev_s, dev_e, dev_corr = [], [], []
    ann, aten, runtime = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = trace._start_ns(e)
        d = e.duration_ns()
        if e.device_type() == cuda:
            if trace._annotation(e, name):
                continue
            dev_s.append(s)
            dev_e.append(s + d)
            if not name.startswith("Memcpy") and \
                    not name.startswith("Memset"):
                dev_corr.append((e.correlation_id(),
                                 getattr(e, "linked_correlation_id",
                                         lambda: 0)()))
        elif name.startswith(trace.PREFIX):
            ann.append((s, s + d, name[len(trace.PREFIX):]))
        elif name.startswith("cuda"):
            if e.correlation_id():
                launch_at[e.correlation_id()] = s
            runtime.append((s, s + d, name))
        elif name.startswith("aten::"):
            aten.append((s, s + d, name))
    at, lost = [], 0
    for c, linked in dev_corr:
        t = launch_at.get(c) or launch_at.get(linked)
        if t is None:
            lost += 1
        else:
            at.append(t)
    where = innermost(tl, at)
    by_span = Counter(names[i] if i >= 0 else "(none)" for i in where)
    out = {"kernels_by_span": dict(by_span.most_common()),
           "kernels_unattributed": lost, "idle_gaps": []}
    if not dev_s:
        return out
    m_s, m_e = trace._union(np.asarray(dev_s, np.int64),
                            np.asarray(dev_e, np.int64))
    gaps = m_s[1:] - m_e[:-1]
    order = np.argsort(-gaps)[:n_gaps]
    mids = (m_e[order] + m_s[order + 1]) // 2
    prog = innermost(tl, mids)
    ann, aten, runtime = _ranges(ann), _ranges(aten), _ranges(runtime)
    for k, i in enumerate(order):
        mid = mids[k]
        label = [_inner(ann, mid), names[prog[k]] if prog[k] >= 0 else None,
                 _inner(aten, mid), _inner(runtime, mid)]
        out["idle_gaps"].append(
            [" | ".join(x for x in label if x) or "host",
             float(gaps[i]) / 1e9])
    return out


def _ranges(ranges):
    return (np.asarray([(s, e) for s, e, _ in ranges],
                       np.int64).reshape(-1, 2), [n for _, _, n in ranges])


def _inner(ranges, t):
    """The name of the latest-starting range that holds ``t``."""
    se, names = ranges
    inside = np.flatnonzero((se[:, 0] <= t) & (se[:, 1] >= t))
    if not len(inside):
        return None
    return names[inside[np.argmax(se[inside, 0])]]

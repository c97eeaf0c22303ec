"""The port's tracer (``sicnav_tpu_torch.utils.tracing``): spans and
counters inside the program, off by default.

A toy NLP stands in for the controller's OCP, so that no test here builds
the full controller. This file imports no JAX, so that it runs on a
machine with a card and without JAX (``tests/conftest.py`` imports JAX):

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py

Tests marked ``gpu`` skip without a card: the clock join against the
profiler's device timeline (50 us), the host-sync and allocator counters.
"""

import time
import warnings
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.func import vmap

from sicnav_tpu_torch.mpc import ipm
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
from sicnav_tpu_torch.utils import tracing

PHASES = ("ipm.grad", "ipm.jac", "ipm.hess", "ipm.kkt", "ipm.search")


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _toy(a):
    """A small NLP in the solver's form: a coupled quadratic cost, one
    curved equality row and box inequalities, over z in R^4."""
    def f_fn(z):
        return torch.sum((z - a) ** 2) + 0.1 * z[0] * z[1]

    def c_fn(z):
        c_e = (z[0] + z[1] + z[2] ** 2 - 1.0)[None]
        c_i = torch.cat([z - 2.0, -z - 2.0, (z[3] - 0.5)[None]])
        return c_e, c_i
    return f_fn, c_fn


def _solve(a, n_iter=4):
    f_fn, c_fn = _toy(a)
    return ipm.solve(f_fn, c_fn, torch.zeros(4, dtype=a.dtype),
                     ipm.IPMSettings(n_iter=n_iter))


def _a(seed=0, batch=None):
    g = torch.Generator().manual_seed(seed)
    shape = (4,) if batch is None else (batch, 4)
    return torch.randn(shape, generator=g, dtype=torch.float64)


def test_off_records_nothing():
    assert not tracing.enabled()
    s1, s2 = tracing.span("control"), tracing.span("ipm.kkt")
    assert s1 is s2 is tracing.NULL
    with tracing.span("control") as sp:
        sp.end(123)
        tracing.count("solves", 1)
    wrapped = tracing.spanned("x")(lambda v: v + 1)
    assert wrapped(1) == 2
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.counts == []


def test_spans_parents_steps_and_self_time():
    """Spans opened at fixed times: parents, step ids (a root ``control``
    starts a step, the env step after it belongs to it) and self times."""
    tracing.enable()
    with tracing.span("control", 0) as c:
        with tracing.span("forecast", 10) as f:
            f.end(30)
        with tracing.span("mpc", 30) as m:
            with tracing.span("mpc.solve", 35) as s:
                with tracing.span("ipm.kkt", 40) as k:
                    tracing.count("solves", 2)
                    k.end(70)
                s.end(90)
            m.end(95)
        c.end(100)
    with tracing.span("env.step", 100) as e:
        e.end(120)
    with tracing.span("control", 200) as c:
        c.end(260)
    tracing.count("outside", 5)
    snap = tracing.snapshot()
    names = [s.name for s in snap.spans]
    assert names == ["control", "forecast", "mpc", "mpc.solve", "ipm.kkt",
                     "env.step", "control"]
    assert [s.parent for s in snap.spans] == [-1, 0, 0, 2, 3, -1, -1]
    assert [s.step for s in snap.spans] == [0, 0, 0, 0, 0, 0, 1]
    off = snap.clock_offset_ns
    assert [s.start_ns - off for s in snap.spans] == [0, 10, 30, 35, 40, 100,
                                                      200]
    # control 100 - forecast 20 - mpc 65; mpc 65 - solve 55; ...
    assert snap.self_ns() == [15, 20, 10, 25, 30, 20, 60]
    assert snap.units("control") == 2
    assert snap.ms_per_unit(["mpc.solve", "ipm.kkt"], "control") == \
        pytest.approx(55 / 1e6 / 2)
    assert snap.ms_per_unit("ipm.hess", "control") is None
    assert snap.first("control").end_ns - snap.first("control").start_ns \
        == 100
    assert snap.total("solves") == 2
    assert snap.total("solves", under="mpc") == 2
    assert snap.total("solves", under="forecast") == 0
    (out,) = [c for c in snap.counts if c.name == "outside"]
    assert (out.span, out.step, out.value) == (-1, 1, 5)
    with pytest.raises(RuntimeError):
        with tracing.span("control"):
            tracing.reset()
    tracing.reset()
    assert tracing.snapshot().spans == []


def test_tick_unit_holds_the_control_span():
    """Inside a ``tick`` the ``control`` span starts no step of its own."""
    tracing.enable()
    for _ in range(2):
        with tracing.span("tick"):
            with tracing.span("observe.resample"):
                pass
            with tracing.span("control"):
                pass
    snap = tracing.snapshot()
    assert [s.step for s in snap.spans] == [0, 0, 0, 1, 1, 1]
    assert snap.units("tick") == 2


def test_ipm_phase_spans_per_iteration():
    """One span of each phase per iteration, and one preconditioner span,
    for one NLP and for a batch under ``vmap``."""
    n_iter = 4
    for batched in (False, True):
        tracing.enable()
        if batched:
            vmap(lambda a: _solve(a, n_iter))(_a(1, batch=3))
        else:
            _solve(_a(1), n_iter)
        snap = tracing.snapshot()
        names = [s.name for s in snap.spans]
        assert names.count("ipm.precond") == 1
        assert names[1:] == list(PHASES) * n_iter
        assert all(s.parent == -1 for s in snap.spans)
        assert all(t >= 0 for t in snap.self_ns())
        tracing.disable()


def test_solve_bit_identical_on_and_off():
    for batched in (False, True):
        def run():
            if batched:
                return vmap(lambda a: _solve(a, 6))(_a(2, batch=3))
            return _solve(_a(2), 6)
        off = run()
        tracing.enable()
        on = run()
        tracing.disable()
        z_off, info_off = off
        z_on, info_on = on
        assert torch.equal(z_off, z_on)
        for x, y in zip(info_off, info_on):
            assert torch.equal(x, y)


class _Carry(NamedTuple):
    prev_ok: torch.Tensor


def test_counters_stay_unread_until_the_snapshot():
    """A device-side counter is kept as the tensor it is: a change made to
    it after ``count`` shows in the snapshot, which reads it once."""
    tracing.enable()
    ok = torch.tensor([True, False, True, True])
    with tracing.span("control"):
        SD._count_solves(_Carry(ok))
    ok[1] = True
    with tracing.span("control"):
        SD._count_solves(_Carry(torch.tensor([False, False, True, False])))
    snap = tracing.snapshot()
    assert snap.total("solves") == 8
    assert snap.total("solves_accepted") == 5
    assert snap.total("solves_accepted", under="control") == 5
    tracing.disable()
    SD._count_solves(_Carry(ok))
    assert tracing.snapshot().total("solves") == 8


def test_sync_warnings_counted_against_the_innermost_span():
    """Each of the sync debug mode's warnings counts once, repeats from one
    line too; other warnings reach the hook that was there before."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        before_show = warnings.showwarning
        before_filters = list(warnings.filters)
        tracing.enable()
        with tracing.span("control"):
            with tracing.span("env.step"):
                for _ in range(3):
                    warnings.warn(tracing.SYNC_MESSAGE + " (probe)")
            warnings.warn(tracing.SYNC_MESSAGE)
            warnings.warn("unrelated")
        snap = tracing.snapshot()
        tracing.disable()
        assert warnings.showwarning is before_show
        assert warnings.filters == before_filters
    assert [str(w.message) for w in shown] == ["unrelated"]
    syncs = [(snap.spans[c.span].name, c.value) for c in snap.counts
             if c.name == "host_syncs"]
    assert syncs == [("env.step", 1)] * 3 + [("control", 1)]
    assert snap.total("host_syncs", under="control") == 4
    assert snap.total("host_syncs", under="env.step") == 3
    here = f"test_torch_tracing.py:{_line_of('(probe)')}"
    assert snap.sync_sites[here] == 3 and sum(snap.sync_sites.values()) == 4


def _line_of(text):
    """The line of this file that holds ``text`` first."""
    with open(__file__) as f:
        return next(i for i, line in enumerate(f, 1) if text in line)


def test_allocator_calls_are_each_spans_own(monkeypatch):
    """The allocator's calls read at every span boundary, kept per span as
    its own share (a fake reader stands in for the card's statistics)."""
    calls = iter([(0, 0), (1, 0), (3, 2), (5, 2)])
    monkeypatch.setattr(tracing, "_alloc_calls", lambda device: next(calls))
    tracing.enable()
    with tracing.span("control"):           # reads (0, 0) ... (5, 2)
        with tracing.span("mpc.solve"):     # reads (1, 0) ... (3, 2)
            pass
    snap = tracing.snapshot()
    own = {(snap.spans[c.span].name, c.name): c.value for c in snap.counts}
    assert own == {("mpc.solve", "device_alloc"): 2,
                   ("mpc.solve", "device_free"): 2,
                   ("control", "device_alloc"): 3}
    assert snap.total("device_alloc", under="control") == 5


def test_realtime_latency_is_the_tick_span(monkeypatch):
    """``select_action``'s ``latency_s`` and the ``tick`` span are the same
    two clock readings."""
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.realtime import StreamingController

    def stub(ocp, model, state, carry, env_cfg, fcfg, settings):
        time.sleep(0.002)
        return torch.zeros(2), carry
    monkeypatch.setattr(SD, "sicnav_diffusion_action", stub)
    cfg = EnvConfig(human_num=3, max_humans=3)
    ctl = StreamingController(cfg, None, device="cpu")
    for k in range(8):
        ctl.observe(0.1 * k, (0.0, 0.1 * k, 0.0), np.ones((3, 2)))
    tracing.enable()
    _, _, diag = ctl.select_action()
    snap = tracing.snapshot()
    assert [s.name for s in snap.spans] == ["tick", "observe.resample",
                                           "observe.copy"]
    tick = snap.spans[0]
    assert tick.end_ns - tick.start_ns == round(diag["latency_s"] * 1e9)


def _probe_offsets(device, n=20):
    """Profile ``n`` program spans each with a ``record_function`` range
    opened at the same point; the starts' differences in ns."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    x = torch.ones(64, device=device)
    tracing.enable(device)
    with profile(activities=acts) as prof:
        for i in range(n):
            with tracing.span(f"probe{i}"), record_function(f"probe{i}"):
                x = x * 1.0001
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    snap = tracing.snapshot()
    tracing.disable()
    rf = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("probe") and e.device_type() == \
                torch.autograd.DeviceType.CPU:
            rf[e.name()] = e.start_ns()
    return [rf[s.name] - s.start_ns for s in snap.spans[1:]]


def test_span_clock_joins_the_profiler():
    """A span's start lies on the profiler's clock: within 1 ms of a
    ``record_function`` range opened at the same point (the first
    range, which pays the profiler's first call, is left out)."""
    gaps = _probe_offsets(torch.device("cpu"))
    assert max(abs(g) for g in gaps) < 1_000_000, gaps


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_span_clock_joins_the_profiler_on_the_card():
    _cuda_or_skip()
    gaps = sorted(abs(g) for g in _probe_offsets(torch.device("cuda")))
    assert gaps[len(gaps) // 2] < 50_000 and gaps[-1] < 200_000, gaps


@pytest.mark.gpu
def test_host_syncs_and_allocator_calls_on_the_card():
    _cuda_or_skip()
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tracing.enable(dev)
    assert torch.cuda.get_sync_debug_mode() == 1
    with tracing.span("control"):
        with tracing.span("env.step"):
            x = torch.ones(1 << 22, device=dev)
            v = x.sum().item()
        del x
        torch.cuda.empty_cache()
    snap = tracing.snapshot()
    tracing.disable()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert v == float(1 << 22)
    assert snap.total("host_syncs", under="env.step") >= 1
    assert snap.total("device_alloc", under="env.step") >= 1
    assert snap.total("device_free", under="control") >= 1

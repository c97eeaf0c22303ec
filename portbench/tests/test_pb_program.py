"""The readers of the program's own spans and counters
(``portbench/lib/program.py``) on synthetic snapshots and a synthetic
profile, and ``program_trace.py`` at a tiny size on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from portbench import program_trace
from portbench.lib import program
from sicnav_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    tracing.disable()
    tracing.reset()


def _spans(plan):
    """Record ``plan``: nested (name, start, end, children) with counts as
    (name, value) tuples among the children."""
    def one(item):
        name, t0, t1, kids = item
        with tracing.span(name, t0) as sp:
            for k in kids:
                if len(k) == 2:
                    tracing.count(*k)
                else:
                    one(k)
            sp.end(t1)
    for item in plan:
        one(item)


def _step(t, accepted):
    ms = 1_000_000
    return ("control", t, t + 100 * ms, [
        ("forecast", t, t + 10 * ms, []),
        ("mpc", t + 10 * ms, t + 95 * ms, [
            ("mpc.problem", t + 10 * ms, t + 12 * ms, []),
            ("mpc.guess", t + 12 * ms, t + 14 * ms, []),
            ("mpc.solve", t + 14 * ms, t + 90 * ms, [
                ("ipm.precond", t + 14 * ms, t + 16 * ms, []),
                ("ipm.grad", t + 16 * ms, t + 20 * ms, []),
                ("ipm.jac", t + 20 * ms, t + 30 * ms, []),
                ("ipm.hess", t + 30 * ms, t + 70 * ms, []),
                ("ipm.kkt", t + 70 * ms, t + 75 * ms,
                 [("device_free", 2)]),
                ("ipm.search", t + 75 * ms, t + 89 * ms, []),
            ]),
            ("mpc.cascade", t + 90 * ms, t + 94 * ms, []),
        ]),
        ("solves", 10), ("solves_accepted", accepted),
        ("host_syncs", 1),
    ])


def test_metrics_from_a_synthetic_snapshot():
    tracing.enable()
    _spans([_step(0, 6)])
    setup = tracing.snapshot()
    tracing.reset()
    ms = 1_000_000
    _spans([_step(0, 9), ("env.step", 100 * ms, 103 * ms,
                          [("host_syncs", 2)]),
            _step(200 * ms, torch.tensor([True] * 7 + [False] * 3))])
    window = tracing.snapshot()
    got = program.metrics(setup, window, "eval")
    assert got == pytest.approx({
        "ipm_jac_ms.eval": 14.0, "ipm_hess_ms.eval": 42.0,
        "ipm_kkt_ms.eval": 5.0, "ipm_search_ms.eval": 14.0,
        "solve_accept_share.eval": 80.0,
        "host_syncs_per_step.eval": 2.0,
        "alloc_calls_per_step.eval": 2.0, "first_step_s.eval": 0.1})
    mpc, parts = program.mpc_parts_ms(window, "eval")
    assert mpc == pytest.approx(85.0)
    assert parts == pytest.approx(84.0)       # 1 ms of mpc's own
    assert program.metrics(None, tracing.snapshot(), "robot") == {}


def test_timeline_gives_the_innermost_span():
    tracing.enable()
    _spans([_step(0, 1)])
    snap = tracing.snapshot()
    off = snap.clock_offset_ns
    tl = program.timeline(snap.spans)
    ms = 1_000_000
    at = [off - 1, off + 5 * ms, off + 50 * ms, off + 92 * ms,
          off + 97 * ms, off + 101 * ms]
    names = [snap.spans[i].name if i >= 0 else None
             for i in program.innermost(tl, at)]
    assert names == [None, "forecast", "ipm.hess", "mpc.cascade", "control",
                     None]


class _Event:
    def __init__(self, name, start, dur, cuda=False, corr=0):
        self._v = (name, start, dur, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return False


def test_join_attributes_kernels_and_labels_gaps():
    tracing.enable()
    _spans([_step(0, 1)])
    snap = tracing.snapshot()
    off = snap.clock_offset_ns
    ms = 1_000_000
    events = [
        _Event("portbench.mpc", off + 10 * ms, 85 * ms),
        # two launches in the Hessian, one in the KKT block, one in the
        # line search
        _Event("cudaLaunchKernel", off + 31 * ms, 10_000, corr=1),
        _Event("cudaLaunchKernel", off + 32 * ms, 10_000, corr=2),
        _Event("cudaLaunchKernel", off + 71 * ms, 10_000, corr=3),
        _Event("aten::linalg_lu_factor_ex", off + 71 * ms + 500_000,
               3 * ms),
        _Event("cudaFree", off + 72 * ms, 2 * ms),
        _Event("cudaLaunchKernel", off + 76 * ms, 10_000, corr=4),
        _Event("k_hess", off + 31 * ms + 5000, 1000, cuda=True, corr=1),
        _Event("k_hess", off + 32 * ms + 5000, 1000, cuda=True, corr=2),
        _Event("k_kkt", off + 71 * ms + 5000, 1000, cuda=True, corr=3),
        _Event("k_search", off + 76 * ms + 5000, 1000, cuda=True, corr=4),
        _Event("k_lost", off + 80 * ms, 1000, cuda=True, corr=9),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    out = program.join(prof, snap, n_gaps=2)
    assert out["kernels_by_span"] == {"ipm.hess": 2, "ipm.kkt": 1,
                                      "ipm.search": 1}
    assert out["kernels_unattributed"] == 1
    assert [g[0] for g in out["idle_gaps"]] == \
        ["mpc | ipm.hess",
         "mpc | ipm.kkt | aten::linalg_lu_factor_ex | cudaFree"]
    assert [g[1] for g in out["idle_gaps"]] == \
        pytest.approx([(39 * ms - 1000) / 1e9, (5 * ms - 1000) / 1e9])


def test_program_trace_takes_the_family_from_the_driver():
    from portbench.lib import registry
    assert program_trace.family(registry.workload(
        "sicnav_diffusion_hallway.robot_b1")) == "robot"
    assert program_trace.family(registry.workload(
        "sicnav_diffusion_hallway.eval_b10")) == "eval"
    assert program_trace.family({"driver": "eval_loop"}) == "eval"
    with pytest.raises(ValueError):
        program_trace.family({"driver": "train_steps"})
    with pytest.raises(ValueError):
        program_trace.family({})


def test_program_trace_rehearsal_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res, snaps = program_trace.trace_cell(
            "sicnav_diffusion_hallway.eval_b10", 7, 0.1, True,
            torch.device("cpu"), sizes={"batch": 2, "ipm": 2})
    finally:
        torch.set_num_threads(n)
    assert set(snaps) == {"setup", "window", "unit"}
    prog = res["program"]
    assert {"ipm_jac_ms.eval", "ipm_hess_ms.eval", "ipm_kkt_ms.eval",
            "ipm_search_ms.eval", "solve_accept_share.eval",
            "host_syncs_per_step.eval", "alloc_calls_per_step.eval",
            "first_step_s.eval"} == set(prog)
    # two iterations a solve: one span of each phase an iteration
    names = [s.name for s in snaps["unit"].spans]
    assert names.count("ipm.kkt") == 2 and names.count("control") == 1
    assert res["mpc_by_spans"]["parts_over_mpc_ms"] == pytest.approx(1.0,
                                                                    abs=0.1)
    assert not tracing.enabled()

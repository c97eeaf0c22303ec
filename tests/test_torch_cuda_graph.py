"""The batched controller as one CUDA graph (``utils/cuda_graph.py``,
``mpc/sicnav_diffusion.act_on_forecasts_batch``) and what capture needs
of the controller: no host data copied to the device on its path.

The protocol's OCP (n_z 173, KKT 317) takes served forecasts made from
each human's constant-velocity path and seeded noise
(``scripts/bench_graph_torch.served``), so no test builds the forecaster
or the JAX reference. This file imports no JAX, so
that it runs on a machine with a card and without JAX
(``tests/conftest.py`` imports JAX):

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_graph.py

Tests marked ``gpu`` skip without a card: at B = 10 protocol cases over
three consecutive steps and a batch reset, the graph against the eager
call (bit for bit), the returned tensors kept across calls, the
counters, no host sync in a replay and no allocator call.
"""

import pathlib
import sys
from typing import NamedTuple

import pytest
import torch
from torch.func import vmap

from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
from sicnav_tpu_torch.utils import cuda_graph as G
from sicnav_tpu_torch.utils import tracing

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent /
                       "scripts"))
from bench_graph_torch import PROTOCOL, protocol_batch, served  # noqa: E402

torch.set_num_threads(2)
N_Z, KKT = 173, 317


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def protocol_cpu():
    return protocol_batch([0, 5], "cpu")


# ------------------------------------------- no host data on the path


class _HostData:
    """Counts ``torch.tensor`` / ``torch.as_tensor`` calls given a device:
    host data copied to it."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("tensor", "as_tensor"):
            monkeypatch.setattr(torch, name, self._wrap(getattr(torch, name),
                                                        name))

    def _wrap(self, real, name):
        def counted(*args, **kwargs):
            if kwargs.get("device") is not None or \
                    (name == "as_tensor" and len(args) > 2):
                self.calls.append(name)
            return real(*args, **kwargs)
        return counted


def _one_problem(ocp, state, fc, lw):
    view, ms, ml, _ = SD.mpc_inputs(ocp, state, fc, lw)
    return C.build_params(ocp, view, PROTOCOL, ms, ml)


def _z0(shape):
    g = torch.Generator().manual_seed(3)
    return 0.1 * torch.randn(shape, generator=g)


PARTS = {
    "residuals": lambda ocp, p, z: ocp.residuals(z, p),
    "cost": lambda ocp, p, z: ocp.cost(z, p),
    "solve": lambda ocp, p, z: ipm.solve(
        lambda y: ocp.cost(y, p), lambda y: ocp.residuals(y, p), z,
        ipm.IPMSettings(n_iter=2)),
}


@pytest.mark.parametrize("batched", [False, True],
                         ids=["unbatched", "vmapped"])
@pytest.mark.parametrize("part", ["build_params", *PARTS])
def test_no_host_data_on_the_controller_path(protocol_cpu, monkeypatch,
                                             part, batched):
    """The protocol OCP's residuals, cost, problem build (default weights)
    and a 2-iteration solve copy no host data to the device: each such
    copy waits for the device, and a CUDA graph cannot hold it."""
    ocp_v, states, _, fc, lw = protocol_cpu
    ocp = ocp_v if batched else SD.OCP(ocp_v.cfg, device="cpu")
    assert (ocp.cfg.n_z, ocp.cfg.n_z + ocp.n_eq) == (N_Z, KKT)
    B = states.r_pos.shape[0]
    if batched:
        def problem():
            return vmap(lambda s, f, w: _one_problem(ocp, s, f, w))(
                states, fc, lw)
        z = _z0((B, N_Z))
    else:
        def problem():
            return _one_problem(ocp, CS.tree_map(lambda x: x[0], states),
                                fc[0], lw[0])
        z = _z0((N_Z,))
    params = problem()
    host = _HostData(monkeypatch)
    with ipm.batched_lu_threads("cpu"):
        if part == "build_params":
            out = problem()
            assert out.cost_w.q_x.shape == ((B,) if batched else ())
        elif batched:
            out = vmap(lambda p, y: PARTS[part](ocp, p, y))(params, z)
        else:
            out = PARTS[part](ocp, params, z)
    assert host.calls == [], (part, host.calls)
    leaves = G.flatten(out)[0]
    assert all(bool(torch.isfinite(x).all()) for x in leaves
               if torch.is_tensor(x) and x.is_floating_point())


# ---------------------------------------------- the graph's bookkeeping


class _Pair(NamedTuple):
    a: torch.Tensor
    flag: torch.Tensor


def _toy(x, pair, scale):
    return x * scale + pair.a.sum(), _Pair(pair.a - x[:, :1],
                                           ~pair.flag)


def _args(B, seed, dtype=torch.float32, scale=2.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, 3), generator=g).to(dtype)
    pair = _Pair(torch.randn((B, 2), generator=g).to(dtype),
                 torch.rand(B, generator=g) > 0.5)
    return (x, pair, scale)


def plain_capture(fn, static):
    """The graph's semantics without a card: the outputs are buffers that
    every replay overwrites from the static inputs."""
    out = fn(*static)

    def replay():
        for o, n in zip(G.flatten(out)[0], G.flatten(fn(*static))[0]):
            o.copy_(n)
    return out, replay


def test_signature_keys():
    key = G.signature(_args(4, 0))
    assert key == G.signature(_args(4, 1))
    assert hash(key) == hash(G.signature(_args(4, 1)))
    assert key != G.signature(_args(5, 0))                     # B
    assert key != G.signature(_args(4, 0, torch.float64))      # dtype
    assert key != G.signature(_args(4, 0, scale=3.0))          # non-tensor
    assert key != G.signature(_args(4, 0), key=("settings",))
    x, pair, s = _args(4, 0)
    assert key != G.signature((x, tuple(pair), s))             # structure
    rebuilt = G.tree_map(lambda v: v, [pair, (x, s)])
    assert type(rebuilt) is list and type(rebuilt[0]) is _Pair
    assert rebuilt[0].a is pair.a and rebuilt[1][1] == s


def test_cache_copies_in_and_clones_out():
    """Calls sharing a signature share one capture; each replay reads the
    call's inputs (copied into the buffers, never aliased) and hands back
    clones, so what an earlier call returned survives the later replays."""
    tracing.enable()
    cache = G.GraphCache(plain_capture)
    a1, a2, a3 = _args(4, 0), _args(4, 1), _args(6, 2)
    r1 = cache(_toy, a1, key=("k",), spans=("mpc", "mpc.graph"))
    kept = G.tree_map(lambda v: v.clone(), r1)
    r2 = cache(_toy, a2, key=("k",), spans=("mpc", "mpc.graph"))
    assert len(cache) == 1
    buffers, out, _ = next(iter(cache._graphs.values()))
    for got, want in zip(G.flatten(r1)[0], G.flatten(kept)[0]):
        assert torch.equal(got, want)
    for got, want in zip(G.flatten(r2)[0], G.flatten(_toy(*a2))[0]):
        assert torch.equal(got, want)
    outs = {x.data_ptr() for x in G.flatten(out)[0]}
    for r in (r1, r2):
        assert not outs & {x.data_ptr() for x in G.flatten(r)[0]}
    ins = {x.data_ptr() for x in G.flatten((a1, a2))[0] if torch.is_tensor(x)}
    assert not ins & {x.data_ptr() for x in buffers if torch.is_tensor(x)}
    cache(_toy, a3, key=("k",))                                # a new B
    cache(_toy, a2, key=("other",))                            # a new key
    assert len(cache) == 3
    snap = tracing.snapshot()
    assert snap.total("graph_captures") == 3
    assert snap.total("graph_replays") == 1
    assert [s.name for s in snap.spans] == ["mpc", "mpc.graph"] * 2


def test_batched_controller_runs_eagerly_on_the_cpu(protocol_cpu):
    """Off a card ``act_on_forecasts_batch`` is the eager vmapped
    controller, exactly, and counts ``graph_eager``."""
    ocp, states, carries, fc, lw = protocol_cpu
    settings = ipm.IPMSettings(n_iter=1)
    tracing.enable()
    got = SD.act_on_forecasts_batch(ocp, states, carries, fc, lw, PROTOCOL,
                                    settings, aux=True)
    snap = tracing.snapshot()
    tracing.disable()
    with ipm.batched_lu_threads("cpu"):
        want = SD.controller_batch(ocp, PROTOCOL, settings, aux=True)(
            states, carries, fc, lw)
    for x, y in zip(G.flatten(got)[0], G.flatten(want)[0]):
        assert torch.equal(x, y)
    assert snap.total("graph_eager") == 1
    assert snap.total("graph_captures") == snap.total("graph_replays") == 0
    assert len(ocp.graphs) == 0


# ------------------------------------------------------------ on the card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _identical(a, b):
    la, lb = G.flatten(a)[0], G.flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.gpu
def test_graph_equals_eager_on_the_card():
    """B = 10 protocol cases at 30 IPM iterations, three consecutive steps
    and a batch reset: each graphed call bit for bit the eager call on the
    same inputs; the first step's returned tensors unchanged after the
    later calls; one capture and three replays; no host sync in a replay
    (sync debug mode "error") and no allocator call under ``control``."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    ocp, states, carries, fc, lw = protocol_batch(list(range(10)), dev)
    settings = ipm.IPMSettings(n_iter=30)

    def eager(st, ca, f, w):
        with ipm.batched_lu_threads(dev), ipm.cusolver_lu(dev):
            return SD.controller_batch(ocp, PROTOCOL, settings)(st, ca, f, w)

    tracing.enable(dev)
    first = kept = None
    for step in range(4):
        if step == 3:
            _, states, carries, fc, lw = protocol_batch(
                list(range(10, 20)), dev, seed=3)
        elif step:
            fc, lw = served(states, step)
        mode = torch.cuda.get_sync_debug_mode()
        if step:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with tracing.span("control"):
                got = SD.act_on_forecasts_batch(ocp, states, carries, fc, lw,
                                                PROTOCOL, settings)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        want = eager(states, carries, fc, lw)
        assert _identical(got, want), step
        if step == 0:
            first, kept = got, G.tree_map(lambda v: v.clone(), got)
        states = CS.step_masked(states, got[0], PROTOCOL)[0]
        carries = got[1]
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    tracing.disable()
    assert _identical(first, kept)
    assert snap.total("graph_captures") == 1
    assert snap.total("graph_replays") == 3
    assert snap.total("graph_eager") == 0
    allocs = sum(c.value for c in snap.counts
                 if c.name in ("device_alloc", "device_free") and c.step >= 1
                 and snap.under(c.span, "control"))
    assert allocs == 0, allocs
    assert snap.total("host_syncs", under="mpc.graph") == 0
    assert len(ocp.graphs) == 1


class _FakeSegments:
    """Records what ``repeat`` asks of a capture under way."""

    def __init__(self):
        self.calls = []

    def begin(self):
        self.calls.append("begin")

    def end(self, times=1):
        self.calls.append(("end", times))


@pytest.mark.parametrize("times", [0, 1, 2, 5])
def test_repeat_loops_and_captures_one_iteration(monkeypatch, times):
    """Without a capture ``repeat`` is the loop. Under one it runs the
    first pass in the open graph, the second in a graph of its own that
    ends by writing its result into the first pass's tensors and replays
    ``times - 1`` times, and opens the next graph."""
    def body(s):
        return _Pair(s.a * 2 + 1, ~s.flag)

    start = _Pair(torch.arange(3.0), torch.tensor([True, False, True]))
    want = start
    for _ in range(times):
        want = body(want)
    got = G.repeat(body, start, times)
    assert torch.equal(got.a, want.a) and torch.equal(got.flag, want.flag)

    seg = _FakeSegments()
    monkeypatch.setattr(G, "_capturing", seg)
    got = G.repeat(body, start, times)
    if times < 2:
        assert seg.calls == []
        assert torch.equal(got.a, want.a)
        return
    assert seg.calls == [("end", 1), "begin", ("end", times - 1), "begin"]
    # the loop's state holds the captured second pass's result
    two = body(body(start))
    assert torch.equal(got.a, two.a) and torch.equal(got.flag, two.flag)

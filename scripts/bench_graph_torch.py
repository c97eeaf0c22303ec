#!/usr/bin/env python3
"""The batched controller (``sicnav_diffusion.act_on_forecasts_batch``)
eager against its CUDA graph, and the batched LU under its two routes.

    python3 scripts/bench_graph_torch.py [--batch 10] [--ipm_iters 30]
        [--reps 5] [--out FILE]

On B protocol cases at their reset, with served forecasts made from each
human's constant-velocity path and seeded noise (``served``), one JSON
line:

- ``eager``: for torch's default LU route and the cuSOLVER route
  (``ipm.cusolver_lu``), the eager vmapped controller's wall per call
  (host clock, ends in a sync) and the own ms of each phase span the
  program's tracer records (``ipm.kkt`` holds the LU), one call each
  after a warm-up call;
- ``lu``: the device time of the IPM's linear algebra of one control
  step, ``ipm_iters`` x (``lu_factor_ex`` + ``lu_solve``) of a batch of
  B (n_z + n_eq)^2 float32 systems, per route (CUDA events over 10 runs,
  median);
- ``graph``: the capturing call's wall, the replays' (median of
  ``reps``), whether each replay equals the eager call on the same inputs
  bit for bit, and over one profiled replay the kernels, the device's busy
  time (the union of kernel intervals), the window and the gaps between
  consecutive kernels (median, p90, sum).

Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sicnav_tpu_torch.env import crowd_sim as CS  # noqa: E402
from sicnav_tpu_torch.env.types import EnvConfig  # noqa: E402
from sicnav_tpu_torch.mpc import campc as C  # noqa: E402
from sicnav_tpu_torch.mpc import ipm  # noqa: E402
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD  # noqa: E402
from sicnav_tpu_torch.utils import cuda_graph as G  # noqa: E402
from sicnav_tpu_torch.utils import tracing  # noqa: E402

PROTOCOL = EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                     human_num=3, max_humans=3, starts_moving=0,
                     time_limit=30, robot_kinematics="unicycle")
PHASES = ("mpc.problem", "mpc.guess", "mpc.solve", "mpc.cascade",
          "ipm.precond", "ipm.grad", "ipm.jac", "ipm.hess", "ipm.kkt",
          "ipm.search")


def served(states, seed, k=10, horizon=8):
    """Served forecasts (B, H, k, horizon + 1, 2) and log-weights (B, H,
    k): each human's constant-velocity path with seeded noise after t = 0,
    and normalized seeded log-weights."""
    g = torch.Generator().manual_seed(seed)
    dev = states.h_pos.device
    B, H = states.h_pos.shape[:2]
    t = torch.arange(horizon + 1, dtype=torch.float32) * PROTOCOL.dt
    pos, vel = states.h_pos.cpu(), states.h_vel.cpu()
    path = pos[:, :, None, None, :] + vel[:, :, None, None, :] * t[:, None]
    noise = 0.05 * torch.randn((B, H, k, horizon + 1, 2), generator=g)
    fc = path + noise * (t[:, None] > 0)
    lw = torch.log_softmax(torch.randn((B, H, k), generator=g), dim=-1)
    return fc.to(dev), lw.to(dev)


def protocol_batch(cases, device, seed=0):
    """(vmapped OCP, states, MPC carries, forecasts, log-weights) of the
    protocol's ``cases`` at their reset."""
    ocp = SD.make_policy(PROTOCOL, None, device=device, batch=True)[0]
    states = CS.reset_batch(PROTOCOL, cases, device=device)
    carries = CS.stack([C.init_carry(ocp) for _ in cases])
    return (ocp, states, carries) + served(states, seed)


def _wall(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def eager_row(ocp, args, settings, dev, cusolver):
    fn = SD.controller_batch(ocp, PROTOCOL, settings)

    def call():
        with ipm.batched_lu_threads(dev):
            if cusolver:
                with ipm.cusolver_lu(dev):
                    return fn(*args)
            return fn(*args)

    _wall(call, dev)
    tracing.enable(dev)
    with tracing.span("control"):
        wall, out = _wall(call, dev)
    snap = tracing.snapshot()
    tracing.disable()
    phases = {p: snap.ms_per_unit(p, "control") for p in PHASES}
    return {"wall_ms": 1e3 * wall, "phases_ms": phases,
            "host_syncs": snap.total("host_syncs"),
            "alloc_calls": snap.total("device_alloc") +
            snap.total("device_free")}, out


def lu_row(B, n, iters, dev, cusolver):
    g = torch.Generator(device=dev).manual_seed(0)
    M = torch.randn((B, n, n), generator=g, device=dev) + \
        n * torch.eye(n, device=dev)
    rhs = torch.randn((B, n, 1), generator=g, device=dev)

    def step():
        for _ in range(iters):
            LU, piv, _ = torch.linalg.lu_factor_ex(M)
            torch.linalg.lu_solve(LU, piv, rhs)

    def timed():
        step()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        runs = []
        for _ in range(10):
            a.record()
            step()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b))
        return statistics.median(runs)

    if cusolver:
        with ipm.cusolver_lu(dev):
            return timed()
    return timed()


def profile_replay(call, dev):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        window = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and not e.name().startswith("Memcpy")
          and not e.name().startswith("Memset")]
    if not iv:
        return {"kernels": 0, "window_ms": 1e3 * window}
    iv = np.asarray(sorted(iv), np.int64)
    run_end = np.maximum.accumulate(iv[:, 1])
    gaps = np.clip(iv[1:, 0] - run_end[:-1], 0, None)
    busy = float((iv[-1, 1] - iv[0, 0]) - gaps.sum())
    return {"kernels": int(len(iv)), "window_ms": 1e3 * window,
            "busy_ms": busy / 1e6, "span_ms": float(iv[-1, 1] - iv[0, 0]) / 1e6,
            "gap_median_us": float(np.median(gaps)) / 1e3,
            "gap_p90_us": float(np.percentile(gaps, 90)) / 1e3,
            "gap_sum_ms": float(gaps.sum()) / 1e6}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_graph_torch needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    settings = ipm.IPMSettings(n_iter=a.ipm_iters)
    ocp, states, carries, fc, lw = protocol_batch(list(range(a.batch)), dev)
    args = (states, carries, fc, lw)
    n = ocp.cfg.n_z + ocp.n_eq
    res = {"device": torch.cuda.get_device_name(0), "batch": a.batch,
           "ipm_iters": a.ipm_iters, "kkt_dim": n, "eager": {}, "lu": {}}
    for route, cus in (("default", False), ("cusolver", True)):
        res["eager"][route], out = eager_row(ocp, args, settings, dev, cus)
        res["lu"][route] = {"step_ms": lu_row(a.batch, n, a.ipm_iters, dev,
                                              cus)}
    want = out

    def graphed(args):
        return SD.act_on_forecasts_batch(ocp, *args, PROTOCOL, settings)

    tracing.enable(dev)
    capture_s, got = _wall(lambda: graphed(args), dev)
    snap = tracing.snapshot()
    tracing.disable()
    same = [all(torch.equal(x, y) for x, y in
                zip(G.flatten(got)[0], G.flatten(want)[0]))]
    walls = []
    for r in range(a.reps):
        args_r = (states, carries) + served(states, r + 1)
        w, got = _wall(lambda: graphed(args_r), dev)
        walls.append(w)
        if r < 2:
            _, want = eager_row(ocp, args_r, settings, dev, True)
            same.append(all(torch.equal(x, y) for x, y in
                            zip(G.flatten(got)[0], G.flatten(want)[0])))
    res["graph"] = {"capture_call_s": capture_s,
                    "capture_host_syncs": snap.total("host_syncs"),
                    "replay_ms": [1e3 * w for w in walls],
                    "replay_median_ms": 1e3 * statistics.median(walls),
                    "bit_identical": same,
                    "profile": profile_replay(lambda: graphed(args), dev)}
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

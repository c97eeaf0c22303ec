#!/usr/bin/env python3
"""Decompose the SICNav-Diffusion control step's latency on the PyTorch
port (twin of scripts/bench_control_step.py): (1) the JMID forecast
(history, encoder, DDIM sampling, KDE top-k on the CUDA kernel), (2) the
plain bilevel CAMPC solve, (3) the fused step, and the KKT-sized linear
solve that bounds the IPM's per-iteration cost, once and as a batch of 16.

    python scripts/bench_control_step_torch.py [--ipm_iters 30]
        [--multi_start N] [--adaptive_effort A] [--device cpu]

Takes every option of the reference script and prints one JSON object with
its keys (``forecast_ms``, ``campc_solve_ms``, ``fused_step_ms``,
``kkt_solve_1x_ms``, ``kkt_solve_16x_ms``, ``kkt_dim``, ``ipm_iters``,
``per_iter_solve_share_ms``; ``multi_start``, ``adaptive_effort`` and
``campc_escalated_ms`` when asked for). Each row is the median over 20
calls on the host clock, after one warm-up call, each call followed by
``torch.cuda.synchronize()``. The environment is host case 1 of the
hallway bottleneck (3 ORCA-plus humans); the predictor's weights are
drawn from seed 0 (the time does not depend on them). The KKT rows time
``torch.linalg.solve`` on a diagonally dominant (n_z + n_eq)^2 system of
the fused OCP. Runs on CUDA unless ``--device cpu`` (port only). Imports
no JAX.
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--num_samples", type=int, default=48)
    p.add_argument("--num_ret_samples", type=int, default=10)
    p.add_argument("--encoder_dim", type=int, default=128)
    p.add_argument("--tf_layer", type=int, default=2)
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--multi_start", type=int, default=1,
                   help="starts per solve for the plain-CAMPC row")
    p.add_argument("--adaptive_effort", type=int, default=0,
                   help="MPCConfig.adaptive_effort: also times the "
                        "ESCALATED step (previous solve rejected -> "
                        "n_iter + adaptive_effort iterations) beside the "
                        "happy-path step of the same policy")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p.parse_args(argv)


def timeit(fn, *args, reps=20, device=None):
    """Median ms of ``reps`` calls of ``fn(*args)`` after one warm-up
    call, on the host clock, each call ended by a device synchronize."""
    def sync():
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize()

    fn(*args)
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(statistics.median(ts))


def measure(args, device, reps=20):
    """The decomposition's rows at ``reps`` calls each. Returns (the JSON
    dict, the fused controller's OCP)."""
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig, init_parameters
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.mpc import campc as C, ipm, sicnav_diffusion as SD
    from sicnav_tpu_torch.mpc.ocp import MPCConfig

    cfg = EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                    human_num=args.num_humans, max_humans=args.num_humans,
                    robot_kinematics="unicycle")
    model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                  tf_layer=args.tf_layer), joint=True,
                      device=device)
    init_parameters(model, torch.Generator().manual_seed(0))
    fcfg = FC.ForecasterConfig(num_samples=args.num_samples,
                               num_ret_samples=args.num_ret_samples,
                               dt=cfg.dt)
    state = CS.reset_host(cfg, case=1, device=device)
    fstate = FC.init_state(cfg.max_humans, fcfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}

    def time_it(fn, *a):
        return timeit(fn, *a, reps=reps, device=device)

    # 1. the forecast alone
    def forecast(fstate, state):
        fs = FC.update_state_hists(fstate, state, fcfg)
        return FC.predict_ret_best(model, fs, state, fcfg, generator=gen)

    out["forecast_ms"] = time_it(forecast, fstate, state)

    # 2. the plain CAMPC solve, at the fused step's settings
    settings = ipm.IPMSettings(n_iter=args.ipm_iters)
    mpc_cfg = None
    if args.multi_start > 1 or args.adaptive_effort > 0:
        mpc_cfg = MPCConfig(num_hums=cfg.max_humans,
                            num_walls=cfg.wall_slots, dt=cfg.dt,
                            multi_start=args.multi_start,
                            adaptive_effort=args.adaptive_effort)
        out["multi_start"] = args.multi_start
    ocp, policy = C.make_policy(cfg, mpc_cfg, settings=settings,
                                device=device)
    carry = C.init_carry(ocp)
    out["campc_solve_ms"] = time_it(lambda s, c: policy(s, c)[0], state,
                                    carry)
    if args.adaptive_effort > 0:
        # the escalated step: the carry says the previous solve was
        # rejected, so the solve runs n_iter + adaptive_effort iterations
        _, carry1 = policy(state, carry)
        esc = carry1._replace(has_prev=torch.ones_like(carry1.has_prev),
                              prev_ok=torch.zeros_like(carry1.prev_ok))
        out["adaptive_effort"] = args.adaptive_effort
        out["campc_escalated_ms"] = time_it(lambda s, c: policy(s, c)[0],
                                            state, esc)

    # 3. the fused step
    ocp2, fused = SD.make_policy(cfg, model, fcfg=fcfg, settings=settings,
                                 device=device)
    fcarry = SD.init_carry(ocp2, cfg.max_humans, fcfg)
    out["fused_step_ms"] = time_it(lambda s, c: fused(s, c)[0], state,
                                   fcarry)

    # 4. the KKT-sized linear solve (the IPM's inner primitive), once and
    # as a batch of 16
    n_m = ocp2.cfg.n_z + ocp2.n_eq
    rng = np.random.default_rng(0)
    A1 = torch.as_tensor(rng.normal(size=(n_m, n_m)).astype(np.float32),
                         device=device) + n_m * torch.eye(n_m, device=device)
    b1 = torch.as_tensor(rng.normal(size=(n_m,)).astype(np.float32),
                         device=device)
    out["kkt_solve_1x_ms"] = time_it(torch.linalg.solve, A1, b1)
    AB = A1.expand(16, n_m, n_m)
    bB = b1.expand(16, n_m)[..., None]
    with ipm.batched_lu_threads(device):
        out["kkt_solve_16x_ms"] = time_it(torch.linalg.solve, AB, bB)
    out["kkt_dim"] = int(n_m)
    out["ipm_iters"] = args.ipm_iters
    out["per_iter_solve_share_ms"] = out["kkt_solve_1x_ms"] * args.ipm_iters
    return out, ocp2


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch.device import resolve_device
    out, _ = measure(args, resolve_device(args.device))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

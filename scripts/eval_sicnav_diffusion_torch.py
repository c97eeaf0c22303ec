#!/usr/bin/env python3
"""Closed-loop SICNav-Diffusion evaluation on the PyTorch port: the JMID
forecaster and the bilevel MPC (twin of scripts/eval_sicnav_diffusion.py).

    python scripts/eval_sicnav_diffusion_torch.py \
        --checkpoint weights/jmid_hallway.npz --num_cases 5

Takes every option of the reference script. Runs seeded episodes (case ==
seed, one at a time) with the fused controller, prints each case's
outcome, then a JSON summary: success rate, mean navigation time,
collision steps and the per-control-step latency (p50, p95) against the
100 ms budget, on the host clock around a step that ends in
``torch.cuda.synchronize()``; the first step (the warm-up) is not
counted. ``--checkpoint`` is the JMID predictor, an ``.npz`` of the
port's state_dict; without it the weights are drawn from seed 0. Runs on
CUDA unless ``--device cpu`` (port only). Imports no JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--checkpoint", default=None,
                   help="JMID weights, an .npz of the port's state_dict "
                        "(weights drawn from seed 0 if omitted)")
    p.add_argument("--num_cases", type=int, default=5)
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--scenario", default="hallway_bottleneck")
    p.add_argument("--num_samples", type=int, default=48)
    p.add_argument("--num_ret_samples", type=int, default=10)
    p.add_argument("--ddim_stride", type=int, default=2,
                   help="DDIM stride (NFE = 100/stride)")
    p.add_argument("--encoder_dim", type=int, default=128)
    p.add_argument("--tf_layer", type=int, default=2)
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--goal_dynamics", action="store_true")
    p.add_argument("--no_close_to_preds", action="store_true")
    p.add_argument("--ral", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None, max_steps=None):
    """The CLI; ``max_steps`` (default: time_limit / dt + 2) cuts each
    episode short. Returns the summary."""
    args = parse_args(argv)
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig, init_parameters
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.mpc import ipm, sicnav_diffusion as SD

    device = resolve_device(args.device)
    env_cfg = EnvConfig(scenario=args.scenario, human_policy="orca_plus"
                        if args.scenario != "circle_crossing" else "orca",
                        human_num=args.num_humans,
                        max_humans=args.num_humans, starts_moving=0,
                        robot_kinematics="unicycle")
    model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                  tf_layer=args.tf_layer), joint=True,
                      device=device)
    if args.checkpoint:
        model.load_state_dict(load_npz(os.path.abspath(args.checkpoint)))
    else:
        init_parameters(model, torch.Generator().manual_seed(0))
    fcfg = FC.ForecasterConfig(num_samples=args.num_samples,
                               num_ret_samples=args.num_ret_samples,
                               ddim_stride=args.ddim_stride, dt=env_cfg.dt)
    ocp, policy = SD.make_policy(
        env_cfg, model, fcfg=fcfg,
        settings=ipm.IPMSettings(n_iter=args.ipm_iters),
        goal_dynamics=args.goal_dynamics,
        close_to_preds=not args.no_close_to_preds, ral=args.ral,
        device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    results, step_times = [], []
    if max_steps is None:
        max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    for case in range(args.num_cases):
        state = CS.reset_host(env_cfg, case=case, device=device)
        carry = SD.init_carry(ocp, env_cfg.max_humans, fcfg, seed=case)
        colls = 0
        for i in range(max_steps):
            sync()
            t0 = time.perf_counter()
            action, carry = policy(state, carry)
            sync()
            if case > 0 or i > 0:        # the first step is the warm-up
                step_times.append(time.perf_counter() - t0)
            state, _, info = CS.step(state, action, env_cfg)
            colls += int(info.collision)
            if bool(state.done):
                break
        results.append(dict(case=case, success=bool(info.reach_goal),
                            nav_time=float(state.t), collisions=colls))
        print(results[-1])

    summary = dict(
        num_cases=len(results),
        success_rate=float(np.mean([r["success"] for r in results])),
        mean_nav_time=float(np.mean([r["nav_time"] for r in results])),
        collision_steps=int(np.sum([r["collisions"] for r in results])),
        control_step_ms_p50=(float(1e3 * np.median(step_times))
                             if step_times else None),
        control_step_ms_p95=(float(1e3 * np.percentile(step_times, 95))
                             if step_times else None),
    )
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The IPM iteration-budget frontier on the PyTorch port (twin of
scripts/sweep_ipm_iters.py).

    python scripts/sweep_ipm_iters_torch.py --iters 10 15 20 30 40 \
        --num_cases 100 --batch 25 [--early_exit 1e-4] [--device cpu]

Takes every option of the reference script. For each iteration cap it runs
the seeded suite through ``scripts/eval_suite_torch.py`` in a subprocess
(the reference script's suite: its 15 s time limit, ``--device`` passed
through) and reads its success / collision / wall / frozen rates, mean
navigation time and reward; for ``--policy campc`` it also times the
control step at that cap (``measure_latency``: the RA-L plain controller
on host case 0, p50 of ``n_steps`` steps on the host clock, each ended by
a device synchronize), since a batched suite's wall is not a control
step's latency. ``--early_exit`` adds rows with a KKT early-exit
tolerance at the largest cap. Prints the frontier as one JSON object
(``--out`` also writes it). ``--policy sicnav_diffusion`` serves
``--checkpoint``, else eval_suite_torch.py's trained weights. Runs on
CUDA unless ``--device cpu`` (port only). Imports no JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SUITE_TIME_LIMIT = 15.0     # scripts/eval_suite.py's default


def run_suite(iters, args, extra=(), early_exit=0.0):
    cmd = [sys.executable, os.path.join(os.path.dirname(
               os.path.abspath(__file__)), "eval_suite_torch.py"),
           "--policy", args.policy, "--scenario", args.scenario,
           "--num_cases", str(args.num_cases), "--batch", str(args.batch),
           "--num_humans", str(args.num_humans),
           "--time_limit", str(SUITE_TIME_LIMIT),
           "--ipm_iters", str(iters),
           "--ipm_early_exit", str(early_exit), *extra]
    if args.privileged:
        cmd.append("--privileged")
    if args.policy == "sicnav_diffusion" and args.checkpoint:
        cmd += ["--checkpoint", args.checkpoint]
    if args.device:
        cmd += ["--device", args.device]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=7200)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    return json.loads(out.stdout[out.stdout.index("{"):])


def measure_latency(iters, args, n_steps=30, early_exit=0.0):
    """Single-episode stepped latency (p50 ms) at this iteration cap."""
    import torch
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.mpc import campc as C, ipm
    from sicnav_tpu_torch.mpc.ocp import MPCConfig

    device = resolve_device(args.device)
    env_cfg = EnvConfig(scenario=args.scenario, human_policy="orca_plus",
                        human_num=args.num_humans,
                        max_humans=args.num_humans, starts_moving=0,
                        robot_kinematics="unicycle")
    mpc_cfg = MPCConfig(num_hums=args.num_humans,
                        num_walls=env_cfg.wall_slots, dt=env_cfg.dt,
                        priviledged_info=args.privileged,
                        robot_nx=8, robot_capsule=True, term_q_coeff=75.0,
                        slack_mode="acados")
    ocp, policy = C.make_policy(env_cfg, mpc_cfg,
                                settings=ipm.IPMSettings(
                                    n_iter=iters, early_exit_tol=early_exit),
                                device=device)
    state = CS.reset_host(env_cfg, case=0, device=device)
    carry = C.init_carry(ocp)
    action, carry = policy(state, carry)        # warm-up
    ts = []
    for _ in range(n_steps):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        action, carry = policy(state, carry)
        action = action.cpu()                   # waits for the step
        ts.append(time.perf_counter() - t0)
        state, _, _ = CS.step(state, action.to(device), env_cfg)
    return float(statistics.median(ts) * 1000)


def _row(iters, res):
    return {"iters": iters,
            "success": res["success_rate"],
            "coll_ep": res["collision_episode_rate"],
            "wall_ep": res["wall_collision_episode_rate"],
            "frozen_ep": res["frozen_episode_rate"],
            "nav_time": res["mean_nav_time"],
            "reward": res["mean_total_reward"]}


def main(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--iters", nargs="*", type=int,
                   default=[10, 15, 20, 30, 40])
    p.add_argument("--policy", default="campc")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--scenario", default="hallway_bottleneck")
    p.add_argument("--num_cases", type=int, default=100)
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--batch", type=int, default=25)
    p.add_argument("--privileged", action="store_true")
    p.add_argument("--skip_latency", action="store_true")
    p.add_argument("--early_exit", nargs="*", type=float, default=[],
                   help="extra frontier rows: KKT early-exit tolerances "
                        "swept at the LARGEST --iters cap")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda), passed "
                        "to eval_suite_torch.py")
    args = p.parse_args(argv)

    timed = not args.skip_latency and args.policy == "campc"
    rows = []
    for it in args.iters:
        print(f"== {it} iters", file=sys.stderr)
        row = _row(it, run_suite(it, args))
        if timed:
            row["latency_p50_ms"] = measure_latency(it, args)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    for tol in args.early_exit:
        cap = max(args.iters)
        print(f"== early-exit {tol} (cap {cap})", file=sys.stderr)
        row = _row(cap, run_suite(cap, args, early_exit=tol))
        row = {"iters": cap, "early_exit_tol": tol,
               **{k: v for k, v in row.items() if k != "iters"}}
        if timed:
            row["latency_p50_ms"] = measure_latency(cap, args,
                                                    early_exit=tol)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    out = json.dumps({"frontier": rows, "config": vars(args)}, indent=2)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Real-robot streaming control loop, replayed at wall-clock rate, on the
PyTorch port (twin of scripts/real_robot_loop.py).

    python scripts/real_robot_loop_torch.py --case 3 --duration_s 10

Drives ``sicnav_tpu_torch.realtime.StreamingController`` from a recorded
observation stream: one DWA episode of the port (``--case``, hallway
bottleneck, 3 ORCA-plus humans) is upsampled to a ``--sensor_hz`` feed with
timestamps jittered by a seeded numpy generator; the samples are pushed as
wall-clock time reaches them, and the controller runs at a
``--control_hz`` deadline. The first control step runs before the clock
starts. Prints one JSON line: the ticks, latency percentiles and deadline
misses. ``--weights`` (alias ``--checkpoint``) is the JMID predictor, an
``.npz`` of the port's state_dict (default: the trained
weights/jmid_hallway.npz). Runs on CUDA unless ``--device cpu``. Imports no
JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def record_stream(env_cfg, case, sensor_hz, jitter_s, seed=0, device=None):
    """One DWA episode of host case ``case``, upsampled to a sensor feed:
    ([(t, (x, y, th), (H, 2)), ...], goal, active walls)."""
    from sicnav_tpu_torch.env import crowd_sim, rollout
    from sicnav_tpu_torch.policies.dwa import dwa_policy

    state = crowd_sim.reset_host(env_cfg, case, device=device)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    # the one-episode stateless rollout (no leading episode axis)
    _, _, traj = rollout.batch_rollout(
        state, lambda s: dwa_policy(s, env_cfg), env_cfg, max_steps)
    traj = crowd_sim.tree_map(lambda x: x.cpu().numpy(), traj)
    T = traj.r_pos.shape[0]
    t_sim = np.arange(T) * env_cfg.dt
    rng = np.random.default_rng(seed)
    t_feed = np.arange(0.0, t_sim[-1], 1.0 / sensor_hz)
    t_feed = np.clip(t_feed + rng.normal(0, jitter_s, t_feed.shape),
                     0.0, t_sim[-1])
    t_feed.sort()
    th = np.unwrap(traj.r_theta)
    H = traj.h_pos.shape[1]
    stream = []
    for t in t_feed:
        rx = np.interp(t, t_sim, traj.r_pos[:, 0])
        ry = np.interp(t, t_sim, traj.r_pos[:, 1])
        rt = np.interp(t, t_sim, th)
        hp = np.stack([[np.interp(t, t_sim, traj.h_pos[:, h, d])
                        for d in range(2)] for h in range(H)])
        stream.append((float(t), (rx, ry, rt), hp))
    goal = traj.r_goal[0]
    walls = traj.walls[0][traj.wall_mask[0]]
    return stream, goal, walls


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", "--checkpoint", dest="weights",
                   default=os.path.join(ROOT, "weights", "jmid_hallway.npz"),
                   help="the JMID predictor: an .npz of the port's "
                        "state_dict")
    p.add_argument("--scenario", default="hallway_bottleneck")
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--case", type=int, default=3)
    p.add_argument("--control_hz", type=float, default=10.0)
    p.add_argument("--sensor_hz", type=float, default=30.0)
    p.add_argument("--jitter_ms", type=float, default=5.0)
    p.add_argument("--duration_s", type=float, default=10.0)
    p.add_argument("--encoder_dim", type=int, default=128)
    p.add_argument("--tf_layer", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.realtime import StreamingController

    device = resolve_device(args.device)
    env_cfg = EnvConfig(scenario=args.scenario, human_policy="orca_plus",
                        human_num=args.num_humans,
                        max_humans=args.num_humans, starts_moving=0,
                        robot_kinematics="unicycle")
    model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                  tf_layer=args.tf_layer), device=device)
    model.load_state_dict(load_npz(args.weights))
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               dt=env_cfg.dt)

    print("recording sensor stream...", file=sys.stderr)
    stream, goal, walls = record_stream(env_cfg, args.case, args.sensor_hz,
                                        args.jitter_ms / 1000.0,
                                        device=device)
    ctl = StreamingController(env_cfg, model, fcfg=fcfg, device=device)
    ctl.set_goal(goal)
    ctl.set_static_obstacles(walls)

    # warm-up off the clock: the first step's one-off costs
    for t, pose, hums in stream[: max(3, int(args.sensor_hz))]:
        ctl.observe(t, pose, hums)
    ctl.select_action()
    print("warm; starting wall-clock loop", file=sys.stderr)

    deadline = 1.0 / args.control_hz
    lat, misses, ticks = [], 0, 0
    feed_i = 0
    t_wall0 = time.perf_counter()
    n_ticks = int(args.duration_s * args.control_hz)
    for k in range(n_ticks):
        tick_t = k * deadline
        # push every sensor sample whose (sim) timestamp has arrived
        while feed_i < len(stream) and stream[feed_i][0] <= tick_t:
            t, pose, hums = stream[feed_i]
            ctl.observe(t, pose, hums)
            feed_i += 1
        if feed_i == 0:
            continue
        _, _, diag = ctl.select_action()
        lat.append(diag["latency_s"])
        ticks += 1
        if diag["latency_s"] > deadline:
            misses += 1
        # sleep to the next tick boundary (wall clock)
        dt_sleep = t_wall0 + (k + 1) * deadline - time.perf_counter()
        if dt_sleep > 0:
            time.sleep(dt_sleep)
        if feed_i >= len(stream):
            break
    lat = np.asarray(lat)
    print(json.dumps({
        "control_hz": args.control_hz,
        "ticks": ticks,
        "latency_p50_ms": float(np.percentile(lat, 50) * 1000),
        "latency_p95_ms": float(np.percentile(lat, 95) * 1000),
        "latency_max_ms": float(lat.max() * 1000),
        "deadline_ms": deadline * 1000,
        "deadline_misses": misses,
        "deadline_miss_rate": misses / max(ticks, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Synthesize ETH/UCY-format trajectory data from the port's simulated
crowds (twin of ``scripts/synthesize_ethucy.py``).

    python scripts/synthesize_ethucy_torch.py [--out data/eth_synth]
        [--n_scenes 200] [--rollouts_per_file 10] [--humans 6]
        [--steps 50] [--dt 0.4] [--hard] [--device cpu]

Batches of up to 32 crowds (circle and square crossing, ORCA and SFM
humans, a holonomic ORCA robot) are reset on the device
(``crowd_sim.reset_device``) and rolled out together
(``rollout.batch_rollout``). ``--hard`` scales each human's preferred
speed by 0.5-1.6, re-aims every agent at a fresh point of the arena circle
each of ``--segments`` segments, and adds tracker noise (Gaussian
``--obs_noise`` plus 3 % glitches of 0.3 m) to the recorded positions.

Writes the reference's raw layout: tab-separated ``frame track x y`` rows,
frame ids in steps of 10, several rollouts per file with disjoint frame
ranges and unique track ids (the robot is each rollout's last track), in
``train/`` and ``val/`` directories under ``--out``. The device's draws
come from generators seeded per batch, so the files differ from the JAX
script's for the same seed; their layout, scale and distribution are the
same. Runs on the card unless ``--device cpu``.
"""

import argparse
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCENARIOS = ("circle_crossing", "square_crossing")
HUMAN_POLICIES = ("orca", "sfm")


def _uniform(shape, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _on_circle(ang, radius):
    return radius * torch.stack([torch.cos(ang), torch.sin(ang)], -1)


def roll_batch(bi, n, args, device):
    """Batch ``bi``: n crowds rolled out together; returns (pos (n, T, A,
    2), mask (n, T, A)) as numpy, the robot as the last track."""
    from sicnav_tpu_torch.env import crowd_sim as CS, rollout as R
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

    scen = SCENARIOS[bi % len(SCENARIOS)]
    hpol = HUMAN_POLICIES[(bi // len(SCENARIOS)) % len(HUMAN_POLICIES)]
    cfg = EnvConfig(scenario=scen, human_policy=hpol, dt=args.dt,
                    human_num=args.humans, max_humans=args.humans,
                    starts_moving=0, robot_kinematics="holonomic",
                    time_limit=args.steps * args.dt + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed + bi)
    states = CS.reset_device(cfg, n, gen, device=device)

    def policy(s):
        return orca_robot_action(s, cfg)

    if args.hard:
        # per-agent preferred-speed diversity, then goal switching: each
        # segment every agent re-targets a fresh point on the arena circle
        g = torch.Generator(device=device).manual_seed(10_000 + args.seed + bi)
        scale = _uniform(states.h_v_pref.shape, 0.5, 1.6, g, device)
        states = states._replace(h_v_pref=states.h_v_pref * scale)
        seg = max(args.steps // args.segments, 8)
        parts, cur = [], states
        for si in range(args.segments):
            if si > 0:
                H = cur.h_goal.shape[1]
                ang = _uniform((n, H), 0.0, 2 * math.pi, g, device)
                ang_r = _uniform((n,), 0.0, 2 * math.pi, g, device)
                cur = cur._replace(
                    h_goal=_on_circle(ang, cfg.circle_radius),
                    r_goal=_on_circle(ang_r, cfg.circle_radius),
                    done=torch.zeros_like(cur.done),
                    t=torch.zeros_like(cur.t))
            cur, _, traj_s = R.batch_rollout(cur, policy, cfg, max_steps=seg)
            parts.append(traj_s)
        traj = CS.tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)
    else:
        _, _, traj = R.batch_rollout(states, policy, cfg,
                                     max_steps=args.steps)
    h_pos = traj.h_pos.cpu().numpy().astype(np.float64)     # (n, T, H, 2)
    r_pos = traj.r_pos.cpu().numpy().astype(np.float64)     # (n, T, 2)
    h_mask = traj.h_mask.cpu().numpy()
    if args.hard and args.obs_noise > 0:
        nrng = np.random.default_rng(777 + args.seed + bi)
        h_pos = h_pos + nrng.normal(0, args.obs_noise, h_pos.shape)
        r_pos = r_pos + nrng.normal(0, args.obs_noise, r_pos.shape)
        # heavy-tailed tracker glitches on ~3 % of the recorded points
        gl = nrng.random(h_pos.shape[:-1])[..., None] < 0.03
        h_pos = h_pos + gl * nrng.normal(0, 0.3, h_pos.shape)
    pos = np.concatenate([h_pos, r_pos[:, :, None, :]], axis=2)
    mask = np.concatenate([h_mask, np.ones_like(h_mask[..., :1])], axis=2)
    return pos, mask, f"{scen}/{hpol}"


def write_split(tracks, directory, per_file):
    """Rollouts -> ETH-format files of ``per_file`` rollouts each; returns
    the paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for fi in range(0, len(tracks), per_file):
        rows, frame0, tid0 = [], 0, 0
        for pos, mask in tracks[fi:fi + per_file]:
            T, A, _ = pos.shape
            for t in range(T):
                for a in range(A):
                    if mask[t, a]:
                        rows.append((10 * (frame0 + t), tid0 + a,
                                     pos[t, a, 0], pos[t, a, 1]))
            frame0 += T + 5            # a gap between concatenated rollouts
            tid0 += A
        path = os.path.join(directory, f"synth_{fi // per_file:03d}.txt")
        with open(path, "w") as f:
            for fr, tid, x, y in rows:
                f.write(f"{fr}\t{tid}\t{x:.4f}\t{y:.4f}\n")
        paths.append(path)
    return paths


def synthesize(args, device=None, log=None):
    """Roll ``args.n_scenes`` crowds and write the split; returns
    {"train": [paths], "val": [paths]}."""
    from sicnav_tpu_torch.device import resolve_device
    device = resolve_device(device)
    all_tracks = []
    done = bi = 0
    while done < args.n_scenes:
        n = min(32, args.n_scenes - done)
        pos, mask, what = roll_batch(bi, n, args, device)
        all_tracks += [(pos[b], mask[b]) for b in range(n)]
        done += n
        bi += 1
        if log is not None:
            log(f"  rolled {done}/{args.n_scenes} ({what})")
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(all_tracks))
    all_tracks = [all_tracks[i] for i in order]
    n_val = max(int(len(all_tracks) * args.val_fraction), 1)
    splits = {"val": all_tracks[:n_val], "train": all_tracks[n_val:]}
    return {split: write_split(tracks, os.path.join(args.out, split),
                               args.rollouts_per_file)
            for split, tracks in splits.items()}


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("data", "eth_synth"))
    p.add_argument("--n_scenes", type=int, default=200,
                   help="crowd rollouts in all")
    p.add_argument("--rollouts_per_file", type=int, default=10)
    p.add_argument("--humans", type=int, default=6)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--dt", type=float, default=0.4)
    p.add_argument("--val_fraction", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hard", action="store_true",
                   help="per-agent speed scaling, goal switching each "
                        "segment and tracker noise")
    p.add_argument("--segments", type=int, default=3,
                   help="goal-switch segments per rollout (--hard)")
    p.add_argument("--obs_noise", type=float, default=0.05,
                   help="recorded-position noise std in m (--hard)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    paths = synthesize(args, args.device,
                       log=lambda m: print(m, file=sys.stderr))
    for split in ("train", "val"):
        print(f"{split}: {len(paths[split])} files in "
              f"{os.path.join(args.out, split)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

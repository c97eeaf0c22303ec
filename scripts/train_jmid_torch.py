#!/usr/bin/env python3
"""Train a JMID trajectory predictor with the PyTorch port (twin of
``scripts/train_jmid.py``).

    python scripts/train_jmid_torch.py [--device cpu] [--scenario hallway_bottleneck]
        [--n_scenes 64] [--epochs 40] [--encoder_dim 128] [--tf_layer 2]
        [--val_full] [--out build/jmid.npz]

Data comes from batched sim rollouts generated on the device (resets from
``crowd_sim.reset_device``, ORCA humans and an ORCA robot, 60 steps,
examples every 4 steps) or from ETH/UCY-style files (``--data_files``,
``--val_data_files``). Training runs ``mid.fit`` (Adam, per-epoch decay,
early stopping on val ADE) and writes the best parameters to ``--out`` as
an ``.npz`` that ``convert.load_npz`` and
``sicnav_diffusion.make_policy`` take as they are. Prints the example counts
to stderr, then JSON lines: the run's summary, the last epochs, and with
``--val_full`` the full metric sweep over the validation scenes.

Runs on the card unless ``--device cpu``. The iMID method (``--method
mid``), the recipes and the multi-class sim (``--multi_class``,
``--class_mode``, ``--no_dispatch``) need the iMID denoiser and the
class-conditioned encoder, which the port does not have yet.
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

NOT_PORTED = ("needs the iMID denoiser and the class-conditioned encoder, "
              "which the port does not have yet (ROADMAP.md, Queue 1 item 9)")


def sim_env_config(scenario):
    """train_jmid's sim environment: 5 humans in 5 slots starting at once,
    ORCA humans for the crossing scenarios and ORCA-plus otherwise, a
    holonomic robot."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(
        scenario=scenario,
        human_policy="orca" if scenario in ("circle_crossing",
                                            "square_crossing")
        else "orca_plus",
        human_num=5, max_humans=5, starts_moving=0,
        robot_kinematics="holonomic")


def generate_sim_scenes(n_scenes, cfg, seed=0, steps=60, history_len=6,
                        horizon=8, device=None):
    """n_scenes device resets rolled out together for ``steps`` steps with
    the ORCA robot, sliced into examples every 4 steps (numpy
    ``SceneBatch``es). The resets draw from a generator seeded ``seed`` on
    the device."""
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.env import crowd_sim as CS, rollout as R
    from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = CS.reset_device(cfg, n_scenes, gen, device=device)
    _, _, traj = R.batch_rollout(states, lambda s: orca_robot_action(s, cfg),
                                 cfg, max_steps=steps)
    traj = CS.tree_map(lambda x: x.cpu().numpy(), traj)
    examples = []
    for b in range(n_scenes):
        pos, valid = D.scenes_from_env_rollout(
            CS.tree_map(lambda x: x[b], traj))
        examples += D.build_examples(pos, valid, cfg.dt,
                                     history_len=history_len,
                                     horizon=horizon, stride=4)
    return examples


def load_files(files, dt=0.4, history_len=6, horizon=8):
    from sicnav_tpu_torch.diffusion import data as D
    out = []
    for f in files:
        if f.endswith(".txt"):
            pos, valid = D.load_ethucy_txt(f)
        else:
            pos, valid = D.load_trajectory_file(f, dt=dt)
        out += D.build_examples(pos, valid, dt, history_len=history_len,
                                horizon=horizon, max_agents=16)
    return out


def batches(examples, batch_size):
    """Stacked batches of ``batch_size`` examples; a short tail is dropped."""
    from sicnav_tpu_torch.diffusion import data as D
    return [D.stack_batches(examples[i:i + batch_size])
            for i in range(0, len(examples) - batch_size + 1, batch_size)]


def full_sweep(model, examples, tc, device):
    """``eval_scene_full`` on each example, one scene per call (one KDE
    launch each on the card), noise from a generator seeded
    ``tc.seed + 7``; the mean of each metric, NaNs counted apart."""
    from sicnav_tpu_torch.diffusion.mid import eval_scene_full
    gen = torch.Generator(device=device).manual_seed(tc.seed + 7)
    accum = {}
    for ex in examples:
        m = eval_scene_full(model, ex.to_tensors(device), tc.eval_samples,
                            gen, stride=tc.eval_stride)
        for k, v in m.items():
            accum.setdefault(k, []).append(float(v))
    out = {k: float(np.nanmean(v)) for k, v in accum.items()}
    out["non_finite"] = {k: int(np.sum(~np.isfinite(v)))
                         for k, v in accum.items()}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--method", default="mid_jp", choices=["mid", "mid_jp"])
    p.add_argument("--recipe", default=None)
    p.add_argument("--dataset", default="sim", choices=["sim"],
                   help="sim rollouts unless --data_files are given")
    p.add_argument("--data_files", nargs="*", default=[])
    p.add_argument("--val_data_files", nargs="*", default=[])
    p.add_argument("--max_val_batches", type=int, default=0,
                   help="cap validation batches per epoch (0 = all)")
    p.add_argument("--log_dir", default=None,
                   help="per-epoch loss and val ADE as JSONL")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--val_full", action="store_true",
                   help="full metric sweep on the val split after training")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_scenes", type=int, default=64)
    p.add_argument("--scenario", default="circle_crossing")
    p.add_argument("--multi_class", action="store_true")
    p.add_argument("--class_mode", default=None, choices=["speed", "maneuver"])
    p.add_argument("--no_dispatch", action="store_true")
    p.add_argument("--encoder_dim", type=int, default=256)
    p.add_argument("--tf_layer", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("build", "jmid.npz"))
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    for flag, on in (("--method mid", args.method == "mid"),
                     ("--recipe", args.recipe), ("--multi_class",
                                                 args.multi_class),
                     ("--class_mode", args.class_mode),
                     ("--no_dispatch", args.no_dispatch)):
        if on:
            raise NotImplementedError(f"{flag} {NOT_PORTED}")

    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion.mid import JMIDModel, TrainConfig, fit
    from sicnav_tpu_torch.diffusion.models import ModelConfig

    device = resolve_device(args.device)
    val_examples = None
    if args.data_files:
        examples = load_files(args.data_files)
        if args.val_data_files:
            val_examples = load_files(args.val_data_files)
    else:
        examples = generate_sim_scenes(args.n_scenes,
                                       sim_env_config(args.scenario),
                                       args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    rng.shuffle(examples)
    if val_examples is not None:
        rng.shuffle(val_examples)
        val, train = val_examples, examples
    else:
        n_val = max(len(examples) // 10, 1)
        val, train = examples[:n_val], examples[n_val:]

    model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                  tf_layer=args.tf_layer), joint=True,
                      device=device)
    tc = TrainConfig(joint=True, lr=args.lr, epochs=args.epochs or 90,
                     batch_size=args.batch_size, seed=args.seed)
    val_batches = batches(val, tc.batch_size)
    if args.max_val_batches:
        val_batches = val_batches[:args.max_val_batches]
    train_batches = batches(train, tc.batch_size)
    print(json.dumps({"train_examples": len(train), "val_examples": len(val),
                      "train_batches": len(train_batches),
                      "val_batches": len(val_batches), "epochs": tc.epochs,
                      "device": str(device)}), file=sys.stderr)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    _, history = fit(model, train_batches, val_batches, tc,
                     checkpoint_path=out, log_dir=args.log_dir)
    wall = time.perf_counter() - t0
    print(json.dumps({"wall_clock_s": wall, "epochs_run": len(history),
                      "early_stopped": len(history) < tc.epochs,
                      "best_val_ade": min(h["val_ade"] for h in history)}))
    print(json.dumps(history[-3:]))
    if args.val_full:
        print(json.dumps(full_sweep(model, val, tc, device)))
    print("checkpoint:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

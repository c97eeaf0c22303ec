#!/usr/bin/env python3
"""Train a JMID / iMID trajectory predictor with the PyTorch port (twin of
``scripts/train_jmid.py``).

    python scripts/train_jmid_torch.py [--device cpu] [--method mid|mid_jp]
        [--recipe NAME] [--scenario hallway_bottleneck] [--n_scenes 64]
        [--multi_class [--class_mode speed|maneuver] [--no_dispatch]]
        [--epochs 40] [--encoder_dim 128] [--tf_layer 2] [--val_full]
        [--data_files F ...] [--out build/jmid.npz]

Data comes from batched sim rollouts generated on the device (resets from
``crowd_sim.reset_device``, ORCA humans and an ORCA robot, 60 steps,
examples every 4 steps) or from ETH/UCY-style files (``--data_files``,
``--val_data_files``; ``scripts/synthesize_ethucy_torch.py`` writes
them). ``--method mid`` trains iMID (each agent denoised on its own),
``mid_jp`` JMID. ``--recipe`` takes a named recipe of
``diffusion/recipes.py``: its model, learning rate, epochs and batch size,
and for files its history, horizon and frame period. ``--multi_class``
types the sim's agents (pedestrians, bicycles, the robot) and conditions
the encoder on them (``num_node_types=3``; ``--no_dispatch`` keeps the
typed data but a single-class encoder), with bicycles faster
(``--class_mode speed``) or zig-zagging (``maneuver``); it adds a
per-class validation ADE / FDE.

Training runs ``mid.fit`` (Adam, per-epoch decay, early stopping on val
ADE) and writes the best parameters to ``--out`` as an ``.npz`` that
``convert.load_npz`` and ``sicnav_diffusion.make_policy`` take as they are.
Prints the example counts to stderr, then JSON lines: the run's summary,
the last epochs, with ``--multi_class`` the per-class scores and with
``--val_full`` the full metric sweep over the validation scenes. Runs on
the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


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


def _maneuver_rollout(states, pol, cfg, steps, bike, seed, device):
    """Segments of 8 steps; after each, every bicycle's goal is re-aimed 4 m
    ahead along its goal direction turned by 70-120 degrees (to alternate
    sides), and the robot's 4 m along its heading, with done and t cleared
    so later segments still move."""
    from sicnav_tpu_torch.env import crowd_sim as CS, rollout as R
    seg = 8
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    st, trajs = states, []
    for si in range(max(steps // seg, 1)):
        fst, _, traj = R.batch_rollout(st, pol, cfg, max_steps=seg)
        trajs.append(traj)
        lo, hi = math.radians(70.0), math.radians(120.0)
        ang = (lo + (hi - lo) * torch.rand(bike.shape, generator=gen,
                                           device=device)) * \
            (1.0 if si % 2 == 0 else -1.0)
        to_g = fst.h_goal - fst.h_pos
        c, s = torch.cos(ang), torch.sin(ang)
        rot = torch.stack([c * to_g[..., 0] - s * to_g[..., 1],
                           s * to_g[..., 0] + c * to_g[..., 1]], -1)
        dirv = rot / torch.clamp(torch.linalg.norm(rot, dim=-1,
                                                   keepdim=True), min=1e-6)
        new_goal = torch.where(bike[..., None], fst.h_pos + 4.0 * dirv,
                               fst.h_goal)
        # a robot at its goal sets done, which freezes every agent
        r_head = torch.where(
            torch.linalg.norm(fst.r_vel, dim=-1, keepdim=True) > 0.05,
            fst.r_vel, fst.r_goal - fst.r_pos)
        r_dir = r_head / torch.clamp(torch.linalg.norm(r_head, dim=-1,
                                                       keepdim=True),
                                     min=1e-6)
        st = fst._replace(h_goal=new_goal, r_goal=fst.r_pos + 4.0 * r_dir,
                          done=torch.zeros_like(fst.done),
                          t=torch.zeros_like(fst.t))
    return CS.tree_map(lambda *xs: torch.cat(xs, dim=1), *trajs)


def generate_sim_scenes(n_scenes, cfg, seed=0, steps=60, multi_class=False,
                        history_len=6, horizon=8, class_mode="speed",
                        device=None):
    """n_scenes device resets rolled out together for ``steps`` steps with
    the ORCA robot, sliced into examples every 4 steps (numpy
    ``SceneBatch``es). The resets draw from a generator seeded ``seed`` on
    the device.

    ``multi_class`` types the agents: a random 30 % (``class_mode
    'speed'``, at 1.7x preferred speed) or 40 % (``'maneuver'``, at the same
    speed but re-aimed sideways every 8 steps) of the humans are BICYCLE,
    drawn from a generator seeded ``seed + 1``, and the robot is a ROBOT
    track, the last one."""
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.env import crowd_sim as CS, rollout as R
    from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = CS.reset_device(cfg, n_scenes, gen, device=device)
    bike = torch.zeros(states.h_v_pref.shape, dtype=torch.bool,
                       device=device)
    if multi_class:
        g1 = torch.Generator(device=device).manual_seed(seed + 1)
        bike = torch.rand(bike.shape, generator=g1, device=device) < (
            0.3 if class_mode == "speed" else 0.4)
        if class_mode == "speed":
            states = states._replace(h_v_pref=states.h_v_pref * torch.where(
                bike, 1.7, 1.0))

    def pol(s):
        return orca_robot_action(s, cfg)

    if multi_class and class_mode == "maneuver":
        traj = _maneuver_rollout(states, pol, cfg, steps, bike, seed, device)
    else:
        _, _, traj = R.batch_rollout(states, pol, cfg, max_steps=steps)
    traj = CS.tree_map(lambda x: x.cpu().numpy(), traj)
    bike = bike.cpu().numpy()
    examples = []
    for b in range(n_scenes):
        pos, valid = D.scenes_from_env_rollout(
            CS.tree_map(lambda x: x[b], traj), human_only=not multi_class)
        types = None
        if multi_class:
            types = np.zeros((pos.shape[0],), np.int32)
            types[:-1][bike[b][:pos.shape[0] - 1]] = \
                D.NODE_TYPES.index("BICYCLE")
            types[-1] = D.NODE_TYPES.index("ROBOT")   # the robot is last
        examples += D.build_examples(pos, valid, cfg.dt,
                                     history_len=history_len,
                                     horizon=horizon, stride=4, types=types)
    return examples


def split_examples(examples, seed, val_examples=None):
    """(val, train): ``examples`` shuffled in place by a numpy generator
    seeded ``seed`` and the first tenth (at least one) held out; with
    ``val_examples`` those, shuffled next, and every example trains."""
    rng = np.random.default_rng(seed)
    rng.shuffle(examples)
    if val_examples is not None:
        rng.shuffle(val_examples)
        return val_examples, examples
    n_val = max(len(examples) // 10, 1)
    return examples[:n_val], examples[n_val:]


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


def per_class_scores(model, examples, n_samples, device, seed):
    """Each validation agent's min-of-k ADE / FDE grouped by its node type
    (``eval_scene_per_agent`` per example, noise from a generator seeded
    ``seed``): {type: {"n", "ade", "fde"}}."""
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion.mid import eval_scene_per_agent
    gen = torch.Generator(device=device).manual_seed(seed)
    per = {t: {"ade": [], "fde": []} for t in D.NODE_TYPES}
    for ex in examples:
        a, f, ok = (x.cpu().numpy() for x in eval_scene_per_agent(
            model, ex.to_tensors(device), n_samples, gen))
        ty = np.asarray(ex.types())
        for ti, tn in enumerate(D.NODE_TYPES):
            m = ok & (ty == ti)
            per[tn]["ade"] += a[m].tolist()
            per[tn]["fde"] += f[m].tolist()
    return {tn: {"n": len(v["ade"]),
                 "ade": float(np.mean(v["ade"])) if v["ade"] else None,
                 "fde": float(np.mean(v["fde"])) if v["fde"] else None}
            for tn, v in per.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--method", default="mid_jp", choices=["mid", "mid_jp"])
    p.add_argument("--recipe", default=None,
                   help="a named recipe of sicnav_tpu_torch.diffusion."
                        "recipes, e.g. ddim_p3_bs256_lr001_eth")
    p.add_argument("--dataset", default="sim",
                   help="the data's name (sim rollouts unless --data_files "
                        "are given)")
    p.add_argument("--data_files", nargs="*", default=[],
                   help="ETH/UCY-format txt files (in place of sim scenes)")
    p.add_argument("--val_data_files", nargs="*", default=[],
                   help="held-out files for validation (otherwise a 10 %% "
                        "split of --data_files)")
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
    p.add_argument("--multi_class", action="store_true",
                   help="typed sim agents and a class-conditioned encoder "
                        "(num_node_types=3); per-class val ADE / FDE")
    p.add_argument("--class_mode", default="speed",
                   choices=["speed", "maneuver"],
                   help="bicycles 1.7x faster, or zig-zagging at the same "
                        "speed")
    p.add_argument("--no_dispatch", action="store_true",
                   help="--multi_class data with a single-class encoder")
    p.add_argument("--encoder_dim", type=int, default=256)
    p.add_argument("--tf_layer", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("build", "jmid.npz"))
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion.mid import JMIDModel, TrainConfig, fit
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.diffusion.recipes import get_recipe

    device = resolve_device(args.device)
    recipe = get_recipe(args.recipe) if args.recipe else None
    hist_len = recipe.history_len if recipe else 6
    horizon = recipe.horizon if recipe else 8
    dt = recipe.dt if recipe else 0.4
    n_types = 3 if args.multi_class and not args.no_dispatch else 1

    val_examples = None
    if args.data_files:
        examples = load_files(args.data_files, dt, hist_len, horizon)
        if args.val_data_files:
            val_examples = load_files(args.val_data_files, dt, hist_len,
                                      horizon)
    else:
        examples = generate_sim_scenes(args.n_scenes,
                                       sim_env_config(args.scenario),
                                       args.seed,
                                       multi_class=args.multi_class,
                                       class_mode=args.class_mode,
                                       device=device)

    val, train = split_examples(examples, args.seed, val_examples)

    if recipe is not None:
        model = JMIDModel(dataclasses.replace(recipe.model,
                                              num_node_types=n_types),
                          joint=recipe.joint, device=device)
        # the recipe's batch size, as far as the data reaches
        tc = dataclasses.replace(
            recipe.train, seed=args.seed,
            epochs=args.epochs or recipe.train.epochs,
            batch_size=min(recipe.train.batch_size, max(len(train), 1)))
    else:
        joint = args.method == "mid_jp"
        model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                      tf_layer=args.tf_layer,
                                      num_node_types=n_types),
                          joint=joint, device=device)
        tc = TrainConfig(joint=joint, lr=args.lr, epochs=args.epochs or 90,
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
    if args.multi_class:
        print(json.dumps({"per_class": per_class_scores(
            model, val, tc.eval_samples, device, tc.seed + 13)}))
    if args.val_full:
        print(json.dumps(full_sweep(model, val, tc, device)))
    print("checkpoint:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

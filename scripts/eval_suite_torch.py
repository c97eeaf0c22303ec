#!/usr/bin/env python3
"""The seeded evaluation suite on the PyTorch port (twin of
scripts/eval_suite.py for the port's policies).

    python scripts/eval_suite_torch.py --policy dwa --num_cases 10 --batch 10
    python scripts/eval_suite_torch.py --policy sicnav_diffusion \
        --num_cases 500 --batch 10 --progress_file build/accept.jsonl
    python scripts/eval_suite_torch.py --policy sarl \
        --checkpoint weights/sarl_200k.npz --scenario circle_crossing \
        --time_limit 15 --num_cases 200 --batch 50

Runs ``harness.evaluate_policy`` over host cases 0..num_cases-1 (case ==
seed) in batches of ``--batch`` episodes that advance together, one
batched control step at a time, and prints ``harness.summarize``'s dict as
one JSON line. The environment is built as the reference script builds
it: ORCA humans in circle crossing and ORCA-plus humans elsewhere, a
holonomic robot for ``--policy orca_plus`` and a unicycle robot otherwise.
Its defaults are the definitive protocol's (hallway bottleneck, 3 humans
in 3 slots starting at once, 30 s, 122 steps), not the reference script's
(circle crossing, 15 s). ``--policy sicnav_diffusion`` is the fused
controller with the trained JMID weights (``--weights``, 48 samples, KDE
top 10) and ``IPMSettings(n_iter=--ipm_iters)``, so the second command
above is the acceptance run. ``--policy sarl|rgl`` acts greedily on a
value network (``--checkpoint``, an ``.npz`` of the port's state_dict,
e.g. ``weights/sarl_200k.npz``; the third command is the records'
circle-crossing evaluation), and ``--policy orca_plus`` drives the
robot with ORCA-plus. A rerun with the same ``--progress_file`` skips the
batches it already holds.

``--traced OUT.npz`` (sicnav_diffusion only) runs the batches through
``rollout.rollout_episode_traced`` instead and writes the episode stats
(``s_*``), the per-step StepTrace (``t_*``, (cases, steps, ...)) and the
per-step CAMPCAux (``a_*``) to OUT.npz; it keeps no progress file.

Runs on CUDA unless ``--device cpu``. Imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--policy", default="dwa",
                   choices=["dwa", "sicnav_diffusion", "sarl", "rgl",
                            "orca_plus"])
    p.add_argument("--checkpoint", default=None,
                   help="the value network of --policy sarl|rgl: an .npz of "
                        "the port's state_dict (weights/sarl_200k.npz, "
                        "weights/rgl_200k.npz, or train_rl_torch.py's --out)")
    p.add_argument("--allow_random_params", action="store_true",
                   help="evaluate sarl|rgl WITHOUT a checkpoint (parameters "
                        "drawn from seed 0; ablation only)")
    p.add_argument("--num_cases", type=int, default=500)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--phase", default="test", choices=["test", "val"])
    p.add_argument("--progress_file", default=None,
                   help="JSONL per-batch checkpoint; completed batches are "
                        "skipped on rerun")
    p.add_argument("--traced", default=None, metavar="OUT.npz",
                   help="write per-step StepTrace and CAMPCAux to OUT.npz "
                        "(sicnav_diffusion only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--scenario", default="hallway_bottleneck",
                   help="default: the definitive protocol's; the reference "
                        "script's is circle_crossing")
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--time_limit", type=float, default=30.0,
                   help="seconds (default: the protocol's 30; the reference "
                        "script's is 15)")
    p.add_argument("--weights",
                   default=os.path.join(ROOT, "weights", "jmid_hallway.npz"))
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--seed_per_case", action="store_true",
                   help="seed each episode's forecaster noise with its case "
                        "(default: seed 0 for every episode)")
    args = p.parse_args(argv)
    if args.traced and args.policy != "sicnav_diffusion":
        p.error("--traced records the MPC's per-step aux: it needs "
                "--policy sicnav_diffusion")
    if (args.policy in ("sarl", "rgl") and not args.checkpoint
            and not args.allow_random_params):
        p.error(f"--policy {args.policy} requires --checkpoint (pass "
                "--allow_random_params to knowingly evaluate random "
                "weights); refusing to silently benchmark garbage")
    return args


def env_config(args):
    """The reference script's environment: ORCA humans in circle crossing,
    ORCA-plus elsewhere; a holonomic robot for ORCA-plus, else a unicycle."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(
        scenario=args.scenario,
        human_policy=("orca" if args.scenario == "circle_crossing"
                      else "orca_plus"),
        human_num=args.num_humans, max_humans=args.num_humans,
        starts_moving=0, time_limit=args.time_limit,
        robot_kinematics=("holonomic" if args.policy == "orca_plus"
                          else "unicycle"))


def value_policy(args, env_cfg, device, record=None):
    """The batched greedy policy of --policy sarl|rgl on --checkpoint's
    weights; with ``record`` each step's Q-values are appended to it."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import make_network

    net = make_network(args.policy, device=device)
    if args.checkpoint:
        net.load_state_dict(load_npz(args.checkpoint))
    net.eval()
    dqn = D.DQNConfig()
    actions = D.build_action_space(env_cfg, dqn, device)
    return D.greedy_policy(net, env_cfg, dqn, actions, record)


def sicnav_diffusion_policy(args, env_cfg, device, aux=False):
    """(init_carry_fn, step_fn) of the batched fused controller."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.mpc import ipm
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), device=device)
    model.load_state_dict(load_npz(args.weights))
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               dt=env_cfg.dt)
    _, init_carry_fn, step_fn = SD.make_policy(
        env_cfg, model, fcfg=fcfg,
        settings=ipm.IPMSettings(n_iter=args.ipm_iters), device=device,
        batch=True, seed_per_case=args.seed_per_case, aux=aux)
    return init_carry_fn, step_fn


def run_traced(args, env_cfg, device):
    """Batches through rollout_episode_traced; returns the summary and
    writes the traces to args.traced."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env import crowd_sim, rollout

    init_carry_fn, step_fn = sicnav_diffusion_policy(args, env_cfg, device,
                                                     aux=True)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    parts = []
    for start in range(0, args.num_cases, args.batch):
        cases = list(range(start, min(start + args.batch, args.num_cases)))
        states = crowd_sim.reset_batch(env_cfg, cases, args.phase, device)
        _, stats, trace = rollout.rollout_episode_traced(
            states, init_carry_fn(cases), step_fn, env_cfg, max_steps)
        flat = {f"s_{k}": v for k, v in stats._asdict().items()}
        flat.update({f"t_{k}": v for k, v in trace._asdict().items()
                     if k != "aux"})
        flat.update({f"a_{k}": v for k, v in trace.aux._asdict().items()})
        parts.append({k: v.cpu().numpy() for k, v in flat.items()})
        print(f"[traced] cases {start}-{cases[-1]} done", file=sys.stderr,
              flush=True)
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    np.savez(args.traced, **out)
    stats = rollout.EpisodeStats(*[out[f"s_{k}"]
                                   for k in rollout.EpisodeStats._fields])
    return harness.summarize(stats, env_cfg)


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.policies.dwa import dwa_policy_batch
    from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

    device = resolve_device(args.device)
    env_cfg = env_config(args)
    if args.traced:
        res = run_traced(args, env_cfg, device)
    elif args.policy == "dwa":
        res = harness.evaluate_policy(
            lambda s: dwa_policy_batch(s, env_cfg), env_cfg, args.num_cases,
            args.phase, args.batch, progress_file=args.progress_file,
            device=device)
    elif args.policy == "sicnav_diffusion":
        res = harness.evaluate_policy(
            None, env_cfg, args.num_cases, args.phase, args.batch,
            stateful_policy=sicnav_diffusion_policy(args, env_cfg, device),
            progress_file=args.progress_file, device=device)
    else:
        policy = (value_policy(args, env_cfg, device)
                  if args.policy in ("sarl", "rgl")
                  else lambda s: orca_robot_action(s, env_cfg))
        res = harness.evaluate_policy(
            policy, env_cfg, args.num_cases, args.phase, args.batch,
            progress_file=args.progress_file, device=device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

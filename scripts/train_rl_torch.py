#!/usr/bin/env python3
"""Train a SARL or RGL value network on the PyTorch port (twin of
scripts/train_rl.py): the imitation bootstrap from ORCA demonstrations,
then DQN over vectorized environments.

    python scripts/train_rl_torch.py --model sarl --out build/sarl.npz
    python scripts/train_rl_torch.py --device cpu --il_episodes 8 \\
        --il_epochs 2 --total_timesteps 256 --n_envs 8 --out build/sarl.npz

The environment is the reference script's: circle crossing with ORCA
humans (ORCA-plus in other scenarios), a unicycle robot, humans starting
at once. Prints the imitation loss of the first and last epoch, then the
last three history records and the checkpoint's path, each as one JSON
line. The checkpoint is an ``.npz`` of the port's state_dict, which
``scripts/eval_suite_torch.py --policy sarl|rgl --checkpoint`` serves.
``--il_epochs`` and ``--log_every`` exist to cut a run short; their
defaults are the reference's. ``--mesh N`` trains the DQN in N ranks of
its own (``parallel.mesh.launch``), each stepping its share of the
environments from the imitation fit's parameters; rank 0's parameters are
written. Runs on CUDA unless ``--device cpu``. Imports no JAX.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="sarl", choices=["sarl", "rgl"])
    p.add_argument("--total_timesteps", type=int, default=200_000)
    p.add_argument("--n_envs", type=int, default=32)
    p.add_argument("--il_episodes", type=int, default=300)
    p.add_argument("--il_epochs", type=int, default=100)
    p.add_argument("--skip_il", action="store_true")
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--scenario", default="circle_crossing")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--out", default=os.path.join("build", "rl.npz"))
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel DQN over N ranks (parallel.mesh."
                        "launch: NCCL with a card per rank, else gloo "
                        "ranks sharing the device)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def env_config(args):
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(
        scenario=args.scenario,
        human_policy=("orca" if args.scenario == "circle_crossing"
                      else "orca_plus"),
        human_num=args.num_humans, max_humans=args.num_humans,
        starts_moving=0, robot_kinematics="unicycle")


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch.convert import save_npz
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl import imitation as IL
    from sicnav_tpu_torch.rl.networks import make_network

    device = resolve_device(args.device)
    env_cfg = env_config(args)
    net = make_network(args.model, device=device, seed=args.seed)

    if not args.skip_il:
        il_cfg = IL.ILConfig(il_episodes=args.il_episodes,
                             il_epochs=args.il_epochs)
        data = IL.collect_demonstrations(env_cfg, il_cfg, seed=args.seed,
                                         device=device)
        _, losses = IL.fit_value_net(net, data, il_cfg, seed=args.seed)
        print(json.dumps({"il_states": int(data[0].shape[0]),
                          "il_loss_first": losses[0],
                          "il_loss_last": losses[-1]}), flush=True)

    dqn = D.DQNConfig(total_timesteps=args.total_timesteps)
    if args.mesh:
        from sicnav_tpu_torch.parallel.mesh import launch
        # the imitation fit above is the ranks' start; rank 0's result is
        # the one written
        params, history = launch(
            D.train_on_mesh, args.mesh, args.model, env_cfg, dqn,
            args.n_envs, args.seed, None, args.log_every,
            {k: v.cpu() for k, v in net.state_dict().items()},
            device=device)
    else:
        params, history = D.train(net, env_cfg, dqn, n_envs=args.n_envs,
                                  seed=args.seed, log_every=args.log_every,
                                  device=device)
    for rec in history[-3:]:
        print(json.dumps(rec), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_npz(args.out, params)
    print(json.dumps({"checkpoint": args.out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Turn raw trajectory data into training-ready scene arrays with the
PyTorch port (twin of ``scripts/process_data.py``).

    python scripts/process_data_torch.py FILE ... [--source ethucy|jrdb|sim]
        [--dt 0.4] [--history_len 6] [--horizon 8] [--max_agents 16]
        [--augment_rotations N] [--classes PEDESTRIAN,BICYCLE,ROBOT]
        [--out processed_data/train.npz] [--pkl_out F.pkl] [--device cpu]

Reads ETH/UCY txt or JRDB-style csv files (or, with ``--source sim``,
rolls ``--n_sim_scenes`` crowds on the device with
``train_jmid_torch.generate_sim_scenes``), slices them into fixed-shape
``SceneBatch`` examples (``data.build_examples``) with optional rotated
copies, and writes them stacked into one ``.npz``. ``--pkl_out`` also
writes the files' scenes as an Environment pkl of the original MID
package's format (``diffusion/env_pkl.py``; needs ``dill``). ``--device``
only matters for ``--source sim`` (CUDA unless named).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("files", nargs="*", help="raw trajectory files")
    p.add_argument("--source", default="ethucy",
                   choices=["ethucy", "jrdb", "sim"])
    p.add_argument("--dt", type=float, default=0.4)
    p.add_argument("--history_len", type=int, default=6)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--max_agents", type=int, default=16)
    p.add_argument("--augment_rotations", type=int, default=0,
                   help="extra rotated copies per example (15-degree "
                        "steps over 360)")
    p.add_argument("--n_sim_scenes", type=int, default=64)
    p.add_argument("--out", default=os.path.join("processed_data",
                                                 "train.npz"))
    p.add_argument("--pkl_out", default=None,
                   help="also write an Environment pkl of the files' scenes")
    p.add_argument("--classes", default="PEDESTRIAN",
                   help="comma-separated NODE_TYPES to keep; more than one "
                        "gives multi-class examples")
    p.add_argument("--device", default=None,
                   help="torch device for --source sim (default: cuda)")
    args = p.parse_args(argv)
    keep_classes = tuple(args.classes.split(","))

    from sicnav_tpu_torch.diffusion import data as D

    raw_scenes = []   # (name, dt, pos, valid) for the pkl
    examples = []
    if args.source == "sim":
        from sicnav_tpu_torch.env.types import EnvConfig
        from train_jmid_torch import generate_sim_scenes
        cfg = EnvConfig(scenario="circle_crossing", human_policy="orca",
                        human_num=5, max_humans=5, starts_moving=0,
                        robot_kinematics="holonomic", dt=0.25)
        examples = generate_sim_scenes(args.n_sim_scenes, cfg,
                                       device=args.device)
    else:
        frame_div = 10 if args.source == "jrdb" else 1
        for f in args.files:
            pos, valid, types = D.load_trajectory_file(
                f, dt=args.dt, frame_divisor=frame_div,
                center=args.source == "jrdb", keep_classes=keep_classes,
                return_types=True)
            raw_scenes.append((os.path.basename(f).split(".")[0],
                               args.dt, pos, valid))
            examples += D.build_examples(pos, valid, args.dt,
                                         history_len=args.history_len,
                                         horizon=args.horizon,
                                         max_agents=args.max_agents,
                                         types=types)

    if args.augment_rotations > 0:
        rng = np.random.default_rng(0)
        extra = []
        for e in examples:
            for _ in range(args.augment_rotations):
                theta = rng.choice(np.arange(0, 360, 15)) * np.pi / 180.0
                extra.append(D.rotate_scene(e, theta))
        examples += extra

    if not examples:
        raise SystemExit("no examples produced")
    stacked = D.stack_batches(examples)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **stacked._asdict())
    print(f"wrote {len(examples)} scene examples -> {args.out}")
    if args.pkl_out:
        from sicnav_tpu_torch.diffusion import env_pkl as EP
        if not raw_scenes:
            raise SystemExit("--pkl_out requires file sources (not sim)")
        EP.save_environment(args.pkl_out,
                            EP.arrays_to_environment(raw_scenes))
        print(f"wrote an Environment pkl -> {args.pkl_out}")
    return 0


def load_processed(path):
    """A processed .npz back as one stacked SceneBatch (node_type None for
    files written without it)."""
    from sicnav_tpu_torch.diffusion.data import SceneBatch
    z = np.load(path)
    return SceneBatch(**{k: (z[k] if k in z.files else None)
                         for k in SceneBatch._fields})


if __name__ == "__main__":
    sys.exit(main())

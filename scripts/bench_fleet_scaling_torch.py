#!/usr/bin/env python3
"""CAMPC fleet-solve throughput against the number of ranks on the PyTorch
port (twin of scripts/bench_fleet_scaling.py).

    python scripts/bench_fleet_scaling_torch.py [--batch 32] [--iters 20]
        [--reps 5] [--num_humans 3] [--devices 1 2 4 8] [--device cpu]

A fixed batch of bilevel CAMPC control steps (circle crossing, ORCA
humans, the default horizon) is split over 1, 2, 4, ... ranks
(``parallel/fleet.measure`` in each rank of a ``parallel.mesh.launch``:
the same code path as the harness's and the DQN's mesh option and the
dryrun's stage 4). A row is the fastest of ``--reps`` steps after a
warm-up, from every rank's start to the last rank's finish. With one card
the ranks share it over gloo; with a card per rank they run NCCL. A rank
count the batch does not divide is skipped. Prints one JSON row per rank
count, then ``{"table": [...]}`` with each row's speedup over the first.
Runs on CUDA unless ``--device cpu``. Imports no JAX.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--iters", type=int, default=20, help="IPM iterations")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8],
                   help="rank counts")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p.parse_args(argv)


def measure(args):
    """The rows of ``args.devices``, each printed as one JSON line as it
    comes; returns the table with each row's speedup over the first."""
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.parallel import fleet
    from sicnav_tpu_torch.parallel.mesh import launch

    device = resolve_device(args.device)
    rows = []
    for n in args.devices:
        if args.batch % n:
            print(f"# skip {n} ranks: the batch of {args.batch} does not "
                  "divide", file=sys.stderr)
            continue
        rows.append(launch(fleet.measure, n, args.batch, args.num_humans,
                           args.iters, args.reps, device=device))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        r["speedup"] = r["solves_per_s"] / rows[0]["solves_per_s"]
    return rows


def main(argv=None):
    rows = measure(parse_args(argv))
    if rows:
        print(json.dumps({"table": rows}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

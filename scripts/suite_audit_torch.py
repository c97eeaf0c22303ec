#!/usr/bin/env python3
"""Combined episode audit on the PyTorch port (twin of
scripts/suite_audit.py): ONE traced seeded suite -> the summary metrics,
the collision taxonomy and the timeout taxonomy in one JSON report.

    python scripts/suite_audit_torch.py --policy sicnav_diffusion \
        --checkpoint weights/jmid_hallway.npz --time_limit 30 \
        --num_cases 500 --batch 10 --resume_dir build/audit --out audit.json

Takes every option of the reference script. Both taxonomies consume the
same traced rollout (``audit_common_torch.run_traced_suite``), so the
suite runs once; ``--resume_dir`` keeps one ``.npz`` per batch and a
rerun loads them instead of stepping. The report also holds each case's
headline outcome (``per_case``) so that subsets can be compared case for
case. Runs on CUDA unless ``--device cpu`` (port only). Imports no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import audit_common_torch  # noqa: E402
from collision_taxonomy_torch import collision_report  # noqa: E402
from timeout_taxonomy_torch import timeout_report  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    audit_common_torch.add_policy_args(p)
    p.add_argument("--out", default=None, help="write full JSON here")
    p.add_argument("--dump_traces", default=None,
                   help="npz path: dump full per-step traces (all episodes) "
                        "for offline inspection")
    args = p.parse_args(argv)

    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    env_cfg, step_fn, init_carry, max_steps = audit_common_torch.build(
        args, device)
    stats, tr = audit_common_torch.run_traced_suite(
        args, env_cfg, step_fn, init_carry, max_steps, device)

    report = {"summary": harness.summarize(stats, env_cfg),
              "config": {"policy": args.policy, "scenario": args.scenario,
                         "num_cases": args.num_cases, "ral": args.ral,
                         "ipm_iters": args.ipm_iters,
                         "mpc_kw": args.mpc_kw}}
    report.update(collision_report(stats, tr, args, env_cfg))
    report.update(timeout_report(stats, tr, args, env_cfg))
    report["per_case"] = {
        "success": np.asarray(stats.success).astype(int).tolist(),
        "timeout": np.asarray(stats.timeout).astype(int).tolist(),
        "collision": (np.asarray(stats.collision_steps) > 0)
        .astype(int).tolist(),
        "wall_collision": (np.asarray(stats.wall_collision_steps) > 0)
        .astype(int).tolist(),
        "nav_time": np.round(np.asarray(stats.nav_time, float), 2).tolist(),
    }

    if args.dump_traces:
        np.savez(args.dump_traces,
                 **{k: v for k, v in tr.items() if k != "aux"},
                 **{f"aux_{k}": v for k, v in tr["aux"].items()},
                 steps=np.asarray(stats.steps))

    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(json.dumps({k: report[k] for k in
                          ("summary", "collision_classes", "wall_classes",
                           "timeout_classes", "n_timeouts", "frozen_audit")},
                         indent=2))
    else:
        print(out)
    return report


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Per-episode collision / freezing taxonomy of the MPC controllers on the
PyTorch port (twin of scripts/collision_taxonomy.py).

    python scripts/collision_taxonomy_torch.py --policy campc --num_cases 25
    python scripts/collision_taxonomy_torch.py --policy sicnav_diffusion \
        --checkpoint weights/jmid_hallway.npz --time_limit 30 \
        --resume_dir build/audit

Takes every option of the reference script. Runs the seeded suite with
per-step solver telemetry (``campc.CAMPCAux`` through
``audit_common_torch.run_traced_suite``), finds every collision /
wall-collision episode and classifies its mechanism, in this order:

  ebrake               - an emergency-brake action still led to a collision
  rescued              - the best-exact-margin start was executed
  cascade_infeasible   - the cascade adopted the guess: the solve was
                         infeasible
  cascade_unrealistic  - the solve failed the exact-rollout reality check
  cascade_cost_reject  - the solve cost more than the warmstart
  cascade_other        - the guess was adopted for no recorded reason
  adopted_plan_unsafe  - the adopted plan's own exact rollout collided
  model_mismatch       - the adopted plan predicted clearance but the sim
                         collided

then audits the frozen steps (by episode third, beside cascade activity
and the nearest human) and the lengths of the runs of adopted guesses.
Prints one JSON report (``--out`` writes it whole and prints its head).
Runs on CUDA unless ``--device cpu`` (port only). Imports no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import audit_common_torch  # noqa: E402

# classify_episode's classes, in the order it tests them
COLLISION_CLASSES = ("ebrake", "rescued", "cascade_infeasible",
                     "cascade_unrealistic", "cascade_cost_reject",
                     "cascade_other", "adopted_plan_unsafe", "model_mismatch")

def classify_episode(tr, b, kind_steps):
    """tr: numpy StepTrace dict for the batch; b: episode index;
    kind_steps: bool (T,) event mask. Returns (cls, detail)."""
    steps = np.nonzero(kind_steps)[0]
    t = int(steps[0])
    lo = max(0, t - 2)
    w = slice(lo, t + 1)
    aux = tr["aux"]
    braked = aux["braked"][b, w]
    use_guess = aux["use_guess"][b, w]
    detail = {
        "first_step": t,
        "margin_at_t": float(aux["exact_margin"][b, t]),
        "slack_max_at_t": float(aux["slack_max"][b, t]),
        "dmin_at_t": float(tr["dmin"][b, t]),
        "guess_steps_in_window": int(use_guess.sum()),
    }
    if braked.any():
        return "ebrake", detail
    if "rescued" in aux and aux["rescued"][b, w].any():
        # best-exact-margin start executed in place of a failed guess
        # (cfg.rescue_best_margin) during the window
        return "rescued", detail
    if use_guess.any():
        k = lo + int(np.nonzero(use_guess)[0][-1])
        if not aux["sol_feasible"][b, k]:
            return "cascade_infeasible", detail
        if not aux["sol_realistic"][b, k]:
            return "cascade_unrealistic", detail
        if aux["cost_worse"][b, k]:
            return "cascade_cost_reject", detail
        return "cascade_other", detail
    if aux["exact_margin"][b, t] < 0.0:
        return "adopted_plan_unsafe", detail
    return "model_mismatch", detail


def collision_report(stats, tr, args, env_cfg) -> dict:
    """Classify every collision / wall-collision episode of a traced suite
    and run the frozen-phase audit. Importable so a single traced run can
    feed both this and the timeout taxonomy's report
    (scripts/suite_audit_torch.py)."""
    report = {}
    coll_rows, wall_rows = [], []
    coll_counts, wall_counts = {}, {}
    for b in range(args.num_cases):
        if tr["collision"][b].any():
            cls, det = classify_episode(tr, b, tr["collision"][b])
            det["case"] = b
            det["class"] = cls
            coll_counts[cls] = coll_counts.get(cls, 0) + 1
            coll_rows.append(det)
        if tr["wall_collision"][b].any():
            cls, det = classify_episode(tr, b, tr["wall_collision"][b])
            det["case"] = b
            det["class"] = cls
            wall_counts[cls] = wall_counts.get(cls, 0) + 1
            wall_rows.append(det)
    report["collision_classes"] = coll_counts
    report["wall_classes"] = wall_counts
    report["collision_episodes"] = coll_rows
    report["wall_episodes"] = wall_rows

    # frozen-phase audit: distribution of frozen steps over episode thirds,
    # and co-occurrence with cascade activity (solver-stall vs yielding)
    ep_len = np.maximum(np.asarray(stats.steps), 1)
    fro = tr["frozen"]
    thirds = np.zeros(3)
    frozen_with_guess = 0
    frozen_total = 0
    frozen_dmins = []
    for b in range(args.num_cases):
        idx = np.nonzero(fro[b])[0]
        if idx.size == 0:
            continue
        phase_idx = np.minimum((idx * 3) // ep_len[b], 2)
        for ph in phase_idx:
            thirds[ph] += 1
        frozen_with_guess += int(tr["aux"]["use_guess"][b, idx].sum())
        frozen_total += idx.size
        frozen_dmins.append(tr["dmin"][b, idx])
    fd = np.concatenate(frozen_dmins) if frozen_dmins else np.zeros(0)
    fd = fd[np.isfinite(fd)]
    report["frozen_audit"] = {
        "frozen_steps_total": int(frozen_total),
        "by_episode_third": [int(x) for x in thirds],
        "frozen_steps_with_cascade_guess": int(frozen_with_guess),
        "cascade_guess_step_freq": float(
            tr["aux"]["use_guess"][tr["live"]].mean()),
        "ebrake_step_freq": float(tr["aux"]["braked"][tr["live"]].mean()),
        # yielding evidence: distance to the closest human at frozen steps
        # (a robot waiting a door queue freezes with someone close by; a
        # solver stall freezes in open space)
        "frozen_dmin_p50": float(np.median(fd)) if fd.size else None,
        "frozen_dmin_p90": float(np.percentile(fd, 90)) if fd.size else None,
        "frozen_steps_with_human_within_1m": (
            float(np.mean(fd < 1.0)) if fd.size else None),
    }

    # consecutive-failure-window histogram (round-5 adaptive_effort
    # criterion): length distribution of maximal use_guess runs across all
    # live steps — the round-4 taxonomy blamed every residual collision on
    # 2-3-step stale-guess windows, so an effort escalation that works
    # must shift this histogram toward 1
    streaks = {}
    live = np.asarray(tr["live"])
    ug = np.asarray(tr["aux"]["use_guess"]) & live
    for b in range(args.num_cases):
        run = 0
        for v in ug[b]:
            if v:
                run += 1
            elif run:
                streaks[run] = streaks.get(run, 0) + 1
                run = 0
        if run:
            streaks[run] = streaks.get(run, 0) + 1
    report["guess_streak_hist"] = {str(k): streaks[k]
                                   for k in sorted(streaks)}
    report["guess_streaks_ge3"] = int(sum(v for k, v in streaks.items()
                                          if k >= 3))
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    audit_common_torch.add_policy_args(p)
    p.add_argument("--out", default=None, help="write full JSON here")
    args = p.parse_args(argv)
    if args.wall_margin is None and args.policy != "sicnav_diffusion":
        # the plain controller's diagnostic: 0.05 in both robot models
        args.wall_margin = 0.05

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
                         "stage_margin": args.stage_margin,
                         "ipm_iters": args.ipm_iters}}
    report.update(collision_report(stats, tr, args, env_cfg))

    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(json.dumps({k: report[k] for k in
                          ("summary", "collision_classes", "wall_classes",
                           "frozen_audit")}, indent=2))
    else:
        print(out)
    return report


if __name__ == "__main__":
    main()

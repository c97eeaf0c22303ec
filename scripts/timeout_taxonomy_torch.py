#!/usr/bin/env python3
"""Per-episode TIMEOUT taxonomy of the MPC controllers on the PyTorch port
(twin of scripts/timeout_taxonomy.py).

    python scripts/timeout_taxonomy_torch.py --policy sicnav_diffusion \
        --checkpoint weights/jmid_hallway.npz --time_limit 30 \
        --num_cases 100 --resume_dir build/audit

Takes every option of the reference script. Runs the seeded suite with
per-step traces (``audit_common_torch.run_traced_suite``) and classifies
every timeout episode by where it ended relative to the bottleneck door
(y = 0) and what the crowd was doing:

  jam_shared           - robot before the door with a human still on its
                         side heading the same way (a shared door queue)
  door_open_not_taken  - robot before the door while every human had
                         cleared it or came from the far side
  stuck_in_door        - robot inside the door band at the timeout
  post_door_slow       - robot through the door but out of time
  never_progressed     - robot barely moved from its start

Per episode it also reports the frozen / brake / adopted-guess step
fractions, the time of the last forward progress, the distance to the
goal at the timeout and the door-yield latch's economy. Prints one JSON
report (``--out`` writes it whole and prints its head; ``--dump_traces``
writes the timeout episodes' traces to an .npz). Runs on CUDA unless
``--device cpu`` (port only). Imports no JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import audit_common_torch  # noqa: E402


DOOR_BAND = 0.35     # |progress| <= band counts as "in the door"
TIMEOUT_CLASSES = ("jam_shared", "door_open_not_taken", "stuck_in_door",
                   "post_door_slow", "never_progressed")


def _reset_np(env_cfg, case, phase):
    """Host case ``case``'s reset on the CPU, as numpy arrays."""
    from sicnav_tpu_torch.env import crowd_sim
    return crowd_sim.tree_map(lambda x: x.numpy(), crowd_sim.reset_host(
        env_cfg, case, phase, device="cpu"))


def timeout_report(stats, tr, args, env_cfg) -> dict:
    """Classify every timeout episode of a traced suite (stats, tr from
    audit_common_torch.run_traced_suite). Importable so a single traced
    run can feed both this and the collision taxonomy's report
    (scripts/suite_audit_torch.py). Each timed-out case's reset is rebuilt
    on the CPU."""
    report = {}
    timeout = np.asarray(stats.timeout)
    steps = np.asarray(stats.steps)
    rows, counts = [], {}
    aux = tr["aux"]
    for b in range(args.num_cases):
        if not timeout[b]:
            continue
        s0 = _reset_np(env_cfg, b, args.phase)
        T = int(steps[b])
        last = T - 1
        r_dir = float(np.sign(s0.r_goal[1] -
                              s0.r_pos[1])) or 1.0
        h_dir = np.sign(s0.h_goal[:, 1] -
                        s0.h_pos[:, 1])
        h_dir = np.where(h_dir == 0, 1.0, h_dir)
        h_mask = s0.h_mask

        r_prog = tr["r_pos"][b, :T, 1] * r_dir          # (T,)
        h_prog_end = tr["h_pos"][b, last, :, 1] * h_dir  # (H,)
        # a human "blocks" if it is on the robot's approach side of the door
        # (in the robot's progress coordinate) and not finished
        h_rob_side = tr["h_pos"][b, last, :, 1] * r_dir < DOOR_BAND
        h_unfinished = h_prog_end < DOOR_BAND
        blockers = int(np.sum(h_mask & h_rob_side & h_unfinished))

        end_prog = float(r_prog[last])
        dist_goal = float(np.linalg.norm(
            tr["r_pos"][b, last] - s0.r_goal))
        moved = float(np.abs(r_prog - r_prog[0]).max())
        dprog = np.diff(r_prog, prepend=r_prog[0])
        prog_steps = np.nonzero(dprog > 0.02)[0]
        last_prog_t = float(prog_steps[-1] * env_cfg.dt) if prog_steps.size else 0.0

        live = slice(0, T)
        frozen_frac = float(tr["frozen"][b, live].mean())
        brake_frac = float(aux["braked"][b, live].mean())
        guess_frac = float(aux["use_guess"][b, live].mean())
        fro_idx = np.nonzero(tr["frozen"][b, live])[0]
        fro_dmin = tr["dmin"][b, fro_idx] if fro_idx.size else np.zeros(0)
        # yield-latch economy at death (round-5 audit): how much of the
        # episode was spent latched, whether the robot died latched (and
        # how deep into the hold), how often the yield/assert alternation
        # cycled, and whether death happened inside a cooldown window
        latch = tr["latch"][b, live].astype(bool)
        latch_frac = float(latch.mean())
        engagements = int(np.sum(np.diff(latch.astype(int), prepend=0) == 1))
        stall_end = int(tr["door_stall"][b, last])

        if moved < 0.5:
            cls = "never_progressed"
        elif end_prog > DOOR_BAND:
            cls = "post_door_slow"
        elif end_prog >= -DOOR_BAND:
            cls = "stuck_in_door"
        elif blockers > 0:
            cls = "jam_shared"
        else:
            cls = "door_open_not_taken"
        counts[cls] = counts.get(cls, 0) + 1
        rows.append({
            "case": b, "class": cls, "end_progress": round(end_prog, 3),
            "dist_to_goal": round(dist_goal, 3),
            "blockers_at_end": blockers,
            "moved": round(moved, 3),
            "last_progress_t": round(last_prog_t, 2),
            "frozen_frac": round(frozen_frac, 3),
            "brake_frac": round(brake_frac, 3),
            "guess_frac": round(guess_frac, 3),
            "frozen_dmin_p50": (round(float(np.median(fro_dmin)), 3)
                                if fro_dmin.size else None),
            "yield_latch_frac": round(latch_frac, 3),
            "yield_engagements": engagements,
            "latched_at_death": bool(latch[-1]) if latch.size else False,
            "door_stall_at_death": stall_end,
            "in_cooldown_at_death": stall_end < 0 and not (
                bool(latch[-1]) if latch.size else False),
        })

    report["timeout_classes"] = counts
    report["timeout_episodes"] = rows
    report["n_timeouts"] = int(timeout.sum())
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    audit_common_torch.add_policy_args(p)
    p.add_argument("--out", default=None, help="write full JSON here")
    p.add_argument("--dump_traces", default=None,
                   help="npz path: dump r_pos/h_pos/frozen/action traces of "
                        "every timeout episode for offline inspection")
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
    report.update(timeout_report(stats, tr, args, env_cfg))
    timeout = np.asarray(stats.timeout)
    steps = np.asarray(stats.steps)

    if args.dump_traces:
        to_idx = np.nonzero(timeout)[0]
        resets = [_reset_np(env_cfg, int(b), args.phase) for b in to_idx]
        goals = (np.stack([s.r_goal for s in resets]) if resets
                 else np.zeros((0, 2)))
        hgoals = (np.stack([s.h_goal for s in resets]) if resets
                  else np.zeros((0, 0, 2)))
        np.savez(args.dump_traces, cases=to_idx,
                 r_pos=tr["r_pos"][to_idx], h_pos=tr["h_pos"][to_idx],
                 frozen=tr["frozen"][to_idx], action=tr["action"][to_idx],
                 dmin=tr["dmin"][to_idx], steps=steps[to_idx],
                 r_goal=goals, h_goal=hgoals)

    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(json.dumps({k: report[k] for k in
                          ("summary", "timeout_classes", "n_timeouts")},
                         indent=2))
    else:
        print(out)
    return report


if __name__ == "__main__":
    main()

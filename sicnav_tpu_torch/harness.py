"""Evaluation harness: the seeded case protocol (twin of
``sicnav_tpu/harness.py``).

Deterministic case-indexed scenarios (case == RNG seed via
``crowd_sim.reset_batch``), batched rollouts and the reference metric set
(success / collision / wall-collision / frozen / discomfort rates, mean
nav time), with the reference's JSONL progress file and resume rule.

Policies are batched functions here (see ``env/rollout.py``): a batch of
cases advances with one policy call per control step.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict

import numpy as np

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.env import crowd_sim, rollout
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.parallel.mesh import gather_batch


# the dtypes of rollout.EpisodeStats's fields (float32 times, distances and
# rewards, int32 counts), restored on reading a progress file: JSON keeps
# the values, not the types, and a float64 mean of the float32 nav times
# rounds otherwise than the first run's float32 mean (23.175 against
# 23.174999237 over ten cases), so a resumed suite would not reproduce
# its own summary
_STATS_DTYPES = {name: (np.bool_ if name in ("success", "timeout") else
                        np.float32 if name in ("nav_time", "min_dist",
                                               "total_reward") else np.int32)
                 for name in rollout.EpisodeStats._fields}


def _concat(a, b):
    return rollout.EpisodeStats(*[np.concatenate([np.atleast_1d(x),
                                                  np.atleast_1d(y)])
                                  for x, y in zip(a, b)])


def _load_progress(path: str) -> Dict[int, "rollout.EpisodeStats"]:
    """Read a per-batch progress JSONL (written by evaluate_policy) into
    {start_case: EpisodeStats} of the fields' own dtypes. Corrupt/partial
    trailing lines (a worker killed mid-write) are skipped."""
    done = {}
    if not path or not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                stats = rollout.EpisodeStats(
                    **{k: np.asarray(v, _STATS_DTYPES[k])
                       for k, v in rec["stats"].items()})
            except (json.JSONDecodeError, KeyError, TypeError):
                continue
            done[int(rec["start"])] = stats
    return done


def _append_progress(path: str, start: int, stats) -> None:
    rec = {"start": start,
           "stats": {k: np.asarray(v).tolist()
                     for k, v in stats._asdict().items()}}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def evaluate_policy(policy_fn: Callable, cfg: EnvConfig, num_cases: int = 500,
                    phase: str = "test", batch: int = 50,
                    stateful_policy=None, mesh=None,
                    progress_file: str = None, device=None) -> Dict:
    """Run ``num_cases`` seeded episodes, ``batch`` at a time, on
    ``device`` (CUDA unless named); returns the reference summary metrics.

    ``policy_fn(states) -> (B, 2)`` actions of a batch of states (stateless
    policies, e.g. ``dwa.dwa_policy_batch``), or pass
    ``stateful_policy=(init_carry_fn, step_fn)`` for carry-state policies:
    ``init_carry_fn(cases)`` gives the batch's carries and
    ``step_fn(states, carries) -> (actions, carries)`` is one batched
    control step (e.g. ``sicnav_diffusion.make_policy(batch=True)``).

    ``progress_file``: path to a JSONL checkpoint. Each completed batch is
    appended (fsync'd) and a batch already there with as many cases is
    skipped on rerun, so a long suite resumes by re-running the same
    command.

    ``mesh`` (``parallel.mesh.Mesh``, called in every rank of a
    ``parallel.mesh.launch``) shards each batch of cases over the ranks:
    the batch is padded up to a multiple of the mesh's size by replaying
    its last case, each rank resets and rolls out its contiguous rows on
    its own device, the stats are gathered and the padding sliced out, so
    every rank returns the summary the same call gives without a mesh.
    Only rank 0 writes the ``progress_file`` and the log lines.
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    max_steps = int(cfg.time_limit / cfg.dt) + 2
    completed = _load_progress(progress_file)
    running = None

    for start in range(0, num_cases, batch):
        cases = list(range(start, min(start + batch, num_cases)))
        n_valid = len(cases)
        if start in completed:
            prev = completed[start]
            if len(np.atleast_1d(prev.success)) == n_valid:
                running = prev if running is None else _concat(running, prev)
                if lead:
                    print(f"[harness] cases {start}-{start + n_valid - 1}: "
                          f"resumed from {progress_file}",
                          file=sys.stderr, flush=True)
                continue
        if mesh is not None:
            # pad episodes replay the last case and are sliced out below
            cases = cases + [cases[-1]] * ((-n_valid) % mesh.size)
            cases = cases[mesh.rows(len(cases))]
        states = crowd_sim.reset_batch(cfg, cases, phase, device)
        if stateful_policy is None:
            _, stats, _ = rollout.batch_rollout(states, policy_fn, cfg,
                                                max_steps)
        else:
            init_carry_fn, step_fn = stateful_policy
            _, stats = rollout.batch_rollout_stateful(
                states, init_carry_fn(cases), step_fn, cfg, max_steps)
        stats = gather_batch(stats, mesh)
        batch_stats = rollout.EpisodeStats(
            *[np.atleast_1d(x.cpu().numpy())[:n_valid] for x in stats])
        if progress_file and lead:
            _append_progress(progress_file, start, batch_stats)
        # a running summary per batch: a prefix of batches stays
        # reconstructable from the log even without a progress_file
        running = (batch_stats if running is None
                   else _concat(running, batch_stats))
        if lead:
            print(f"[harness] cases {start}-{start + n_valid - 1}: "
                  f"success {float(np.mean(batch_stats.success)):.2f} "
                  f"running {summarize(running, cfg)}",
                  file=sys.stderr, flush=True)

    return summarize(running, cfg)


def summarize(stats, cfg: EnvConfig) -> Dict:
    """The reference metric set of numpy ``EpisodeStats`` (RL_test.py's
    summary, with the frozen / door-yield audit splits)."""
    steps = np.maximum(np.asarray(stats.steps, np.float64), 1.0)
    return {
        "num_cases": int(len(np.atleast_1d(stats.success))),
        "success_rate": float(np.mean(stats.success)),
        "timeout_rate": float(np.mean(stats.timeout)),
        "collision_episode_rate": float(np.mean(stats.collision_steps > 0)),
        "wall_collision_episode_rate": float(
            np.mean(stats.wall_collision_steps > 0)),
        "frozen_episode_rate": float(np.mean(stats.frozen_steps > 0)),
        "mean_nav_time": float(np.mean(np.where(stats.success, stats.nav_time,
                                                cfg.time_limit))),
        "collision_step_freq": float(np.mean(stats.collision_steps / steps)),
        "danger_step_freq": float(np.mean(stats.danger_steps / steps)),
        "frozen_step_freq": float(np.mean(stats.frozen_steps / steps)),
        # frozen steps within 1 m of the goal (terminal braking) vs
        # mid-episode freezing
        "frozen_near_goal_fraction": float(
            np.sum(stats.frozen_near_goal_steps) /
            max(np.sum(stats.frozen_steps), 1)),
        "frozen_far_episode_rate": float(np.mean(
            (stats.frozen_steps - stats.frozen_near_goal_steps) > 0)),
        # door-yield audit: frozen steps under the policy's yield latch
        # (intentional waiting), and the latch's occupancy
        "frozen_yield_fraction": float(
            np.sum(stats.frozen_yield_steps) /
            max(np.sum(stats.frozen_steps), 1)),
        "yield_step_freq": float(np.mean(stats.yield_steps / steps)),
        "mean_total_reward": float(np.mean(stats.total_reward)),
    }

"""Episode rollout loop (twin of ``sicnav_tpu/env/rollout.py``).

The reference scans jitted env steps with ``lax.scan``; here the scan is a
host loop of ``max_steps`` with the same done-masking: a terminated episode
keeps stepping, frozen, so every episode costs the same number of policy
calls.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from sicnav_tpu_torch.env import crowd_sim
from sicnav_tpu_torch.env.types import EnvConfig, SimState
from sicnav_tpu_torch.ops.geometry import norm2


class EpisodeStats(NamedTuple):
    """Per-episode aggregates (0-d tensors)."""
    success: torch.Tensor           # bool — reached goal
    timeout: torch.Tensor           # bool
    nav_time: torch.Tensor          # time at termination (time_limit if timeout)
    collision_steps: torch.Tensor
    wall_collision_steps: torch.Tensor
    frozen_steps: torch.Tensor
    frozen_near_goal_steps: torch.Tensor  # frozen within 1 m of the goal
    danger_steps: torch.Tensor
    yield_steps: torch.Tensor       # steps with the policy's door-yield
                                    # latch engaged (0 without the protocol)
    frozen_yield_steps: torch.Tensor  # frozen steps under the latch
    min_dist: torch.Tensor          # min dmin over episode
    total_reward: torch.Tensor
    steps: torch.Tensor


def init_stats(cfg: EnvConfig, device) -> EpisodeStats:
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=device)

    false = torch.zeros((), dtype=torch.bool, device=device)
    return EpisodeStats(
        success=false, timeout=false, nav_time=f32(cfg.time_limit),
        collision_steps=i32(), wall_collision_steps=i32(), frozen_steps=i32(),
        frozen_near_goal_steps=i32(), danger_steps=i32(), yield_steps=i32(),
        frozen_yield_steps=i32(), min_dist=f32(math.inf),
        total_reward=f32(0.0), steps=i32())


def _carry_field(carry, name):
    """The field ``name`` (e.g. campc.CAMPCCarry's ``door_latch``) anywhere
    in a carry of nested NamedTuples, or None when the policy has none."""
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        if name in carry._fields:
            return getattr(carry, name)
        for x in carry:
            found = _carry_field(x, name)
            if found is not None:
                return found
    return None


def _door_latch(carry, device):
    latch = _carry_field(carry, "door_latch")
    if latch is None:
        return torch.zeros((), dtype=torch.bool, device=device)
    return latch.to(torch.bool)


def update_stats(stats: EpisodeStats, state: SimState, new_state: SimState,
                 reward, info, latch) -> EpisodeStats:
    """Fold one step's events into the episode aggregates (live steps only).
    ``latch``: the policy's door-yield latch after its action."""
    live = ~state.done
    near_goal = norm2(state.r_pos - state.r_goal) < 1.0
    return EpisodeStats(
        success=stats.success | (live & info.reach_goal),
        timeout=stats.timeout | (live & info.timeout),
        nav_time=torch.where(live & info.done, new_state.t, stats.nav_time),
        collision_steps=stats.collision_steps + (live & info.collision),
        wall_collision_steps=stats.wall_collision_steps +
        (live & info.wall_collision),
        frozen_steps=stats.frozen_steps + (live & info.frozen),
        frozen_near_goal_steps=stats.frozen_near_goal_steps +
        (live & info.frozen & near_goal),
        danger_steps=stats.danger_steps + (live & info.danger),
        yield_steps=stats.yield_steps + (live & latch),
        frozen_yield_steps=stats.frozen_yield_steps +
        (live & info.frozen & latch),
        min_dist=torch.minimum(stats.min_dist, torch.where(
            live, info.dmin, torch.full_like(info.dmin, math.inf))),
        total_reward=stats.total_reward + reward,
        steps=stats.steps + live)


def rollout_episode_stateful(state: SimState, carry0, step_fn: Callable,
                             cfg: EnvConfig, max_steps: int):
    """Episode rollout for carry-state policies:
    ``step_fn(state, carry) -> (action, carry)``. Returns (final_state,
    EpisodeStats)."""
    stats = init_stats(cfg, state.t.device)
    pcarry = carry0
    for _ in range(max_steps):
        action, pcarry = step_fn(state, pcarry)
        latch = _door_latch(pcarry, state.t.device)
        new_state, reward, info = crowd_sim.step_masked(state, action, cfg)
        stats = update_stats(stats, state, new_state, reward, info, latch)
        state = new_state
    return state, stats

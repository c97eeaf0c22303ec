"""Episode rollout loops (twin of ``sicnav_tpu/env/rollout.py``).

The reference scans jitted env steps with ``lax.scan``; here the scan is a
host loop of ``max_steps`` with the same done-masking: a terminated episode
keeps stepping, frozen, so every episode costs the same number of policy
calls.

The reference batches episodes by ``jax.vmap`` of a one-episode rollout.
Here a state with a leading episode axis (``crowd_sim.reset_batch``) goes
through the same loop, and the policy takes the whole batch: the KDE
kernel is a ctypes call, which ``torch.func.vmap`` cannot trace, and the
forecaster draws each episode's noise from that episode's own
``torch.Generator``. So ``policy_fn`` and ``step_fn`` are batched
functions, and the loops below are the one-episode loops run on B
episodes at once.
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


def init_stats(cfg: EnvConfig, device, lead=()) -> EpisodeStats:
    """Stats of ``lead``-shaped batches of episodes that have not begun."""
    def i32():
        return torch.zeros(lead, dtype=torch.int32, device=device)

    def f32(x):
        return torch.full(lead, x, dtype=torch.float32, device=device)

    false = torch.zeros(lead, dtype=torch.bool, device=device)
    return EpisodeStats(
        success=false, timeout=false, nav_time=f32(cfg.time_limit),
        collision_steps=i32(), wall_collision_steps=i32(), frozen_steps=i32(),
        frozen_near_goal_steps=i32(), danger_steps=i32(), yield_steps=i32(),
        frozen_yield_steps=i32(), min_dist=f32(math.inf),
        total_reward=f32(0.0), steps=i32())


def _carry_field(carry, name):
    """The field ``name`` (e.g. campc.CAMPCCarry's ``door_latch``) anywhere
    in a carry tree, or None when the policy has none."""
    return next((getattr(node, name) for node in crowd_sim.tree_nodes(carry)
                 if name in getattr(node, "_fields", ())), None)


def _door_latch(carry, state: SimState):
    latch = _carry_field(carry, "door_latch")
    if latch is None:
        return torch.zeros_like(state.done)
    return latch.to(torch.bool)


def _door_stall(carry, state: SimState):
    stall = _carry_field(carry, "door_stall")
    if stall is None:
        return torch.zeros_like(state.step_idx)
    return stall


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


def batch_rollout(states: SimState, policy_fn: Callable, cfg: EnvConfig,
                  max_steps: int):
    """Rollout of stateless policies: ``policy_fn(states) -> (..., 2)``
    actions for the states' leading episode axes (none for one episode).
    Returns (final_state, EpisodeStats, trajectory: the states after each
    step, stacked on a time axis after the episode axes)."""
    stats = init_stats(cfg, states.t.device, states.t.shape)
    traj = []
    for _ in range(max_steps):
        action = policy_fn(states)
        new_states, reward, info = crowd_sim.step_masked(states, action, cfg)
        stats = update_stats(stats, states, new_states, reward, info,
                             torch.zeros_like(states.done))
        states = new_states
        traj.append(states)
    axis = states.t.dim()
    return states, stats, crowd_sim.tree_map(
        lambda *xs: torch.stack(xs, dim=axis), *traj)


def rollout_episode_stateful(state: SimState, carry0, step_fn: Callable,
                             cfg: EnvConfig, max_steps: int):
    """Episode rollout for carry-state policies:
    ``step_fn(state, carry) -> (action, carry)``. Returns (final_state,
    EpisodeStats). The state may carry leading episode axes; ``step_fn``
    then takes and returns the batch (``batch_rollout_stateful``)."""
    stats = init_stats(cfg, state.t.device, state.t.shape)
    pcarry = carry0
    for _ in range(max_steps):
        action, pcarry = step_fn(state, pcarry)
        latch = _door_latch(pcarry, state)
        new_state, reward, info = crowd_sim.step_masked(state, action, cfg)
        stats = update_stats(stats, state, new_state, reward, info, latch)
        state = new_state
    return state, stats


def batch_rollout_stateful(states: SimState, carries, step_fn: Callable,
                           cfg: EnvConfig, max_steps: int):
    """B episodes of a carry-state policy at once: ``states`` and
    ``carries`` carry a leading episode axis and
    ``step_fn(states, carries) -> (actions (B, 2), carries)`` is one batched
    control step (e.g. ``sicnav_diffusion.make_policy(batch=True)``), so
    every launch of the policy serves the B episodes. Returns
    (final_states, EpisodeStats of (B,) tensors)."""
    return rollout_episode_stateful(states, carries, step_fn, cfg, max_steps)


class StepTrace(NamedTuple):
    """Per-step episode trace for the safety taxonomy audit: env events and
    the policy's per-step aux telemetry (e.g. campc.CAMPCAux)."""
    live: torch.Tensor
    collision: torch.Tensor
    wall_collision: torch.Tensor
    frozen: torch.Tensor
    dmin: torch.Tensor
    r_pos: torch.Tensor          # (..., 2)
    h_pos: torch.Tensor          # (..., H, 2) for queue/jam audits
    action: torch.Tensor         # (..., 2)
    latch: torch.Tensor          # bool: door-yield latch engaged this step
    door_stall: torch.Tensor     # int32: campc.CAMPCCarry.door_stall, the
    #                              latch economy's counter (unlatched >= 0
    #                              stalled steps, < 0 the cooldown, latched
    #                              the hold)
    aux: object                  # the policy's aux NamedTuple


def rollout_episode_traced(state: SimState, carry0, step_fn: Callable,
                           cfg: EnvConfig, max_steps: int):
    """Stateful rollout that also stacks a per-step StepTrace.
    ``step_fn(state, carry) -> (action, carry, aux)``. Returns
    (final_state, EpisodeStats, StepTrace). The state may carry leading
    episode axes (``step_fn`` then takes the batch); the trace's time axis
    comes after them, (B, T, ...), the layout of the reference's vmapped
    traced rollout."""
    stats = init_stats(cfg, state.t.device, state.t.shape)
    pcarry = carry0
    trace = []
    for _ in range(max_steps):
        action, pcarry, aux = step_fn(state, pcarry)
        latch = _door_latch(pcarry, state)
        new_state, reward, info = crowd_sim.step_masked(state, action, cfg)
        stats = update_stats(stats, state, new_state, reward, info, latch)
        live = ~state.done
        trace.append(StepTrace(
            live=live, collision=live & info.collision,
            wall_collision=live & info.wall_collision,
            frozen=live & info.frozen, dmin=info.dmin, r_pos=state.r_pos,
            h_pos=state.h_pos, action=action, latch=latch,
            door_stall=_door_stall(pcarry, state), aux=aux))
        state = new_state
    axis = state.t.dim()
    return state, stats, crowd_sim.tree_map(
        lambda *xs: torch.stack(xs, dim=axis), *trace)

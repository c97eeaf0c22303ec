"""CrowdSimPlus-equivalent environment (twin of
``sicnav_tpu/env/crowd_sim.py``).

``step`` is the original simulator's step — human policy, exact wall
clamping, collision / reward / termination semantics and integration — as
one function of tensors. ``reset_host`` reproduces the seeded evaluation
protocol (case index == RNG seed) on the chosen device; ``reset_device``
draws n training resets at once from a ``torch.Generator``.

A state may carry leading episode axes (``reset_batch``): every function
here indexes from the trailing end, so B episodes step as one call, and
their B x H humans go through the ORCA LP as one batch. The reference
``vmap``s one episode's step instead; the port's LP reads one flag on the
host per call, which ``torch.func.vmap`` cannot trace.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.env import scenarios, walls as walls_mod
from sicnav_tpu_torch.env.human_policies import human_actions
from sicnav_tpu_torch.env.types import DoorParams, EnvConfig, SimState, StepInfo
from sicnav_tpu_torch.env.wall_clamp import (
    clamp_holonomic_action, clamp_unicycle_action,
)
from sicnav_tpu_torch.ops.geometry import norm2, wrap_angle
from sicnav_tpu_torch.utils import tracing


# A tree is nested tuples and NamedTuples of tensors: DoorParams nests in
# SimState, and the observation filter's carry is a plain (KFState, inner)
# pair. Every tuple is a node; anything else is a leaf.

def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over trees of the same structure."""
    first = trees[0]
    if isinstance(first, tuple):
        children = [tree_map(fn, *leaves) for leaves in zip(*trees)]
        return (type(first)(*children) if hasattr(first, "_fields")
                else tuple(children))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of ``tree``, in field order."""
    if isinstance(tree, tuple):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure around ``leaves`` (in tree_leaves' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_nodes(tree):
    """Every node of ``tree``, parents before their children."""
    if isinstance(tree, tuple):
        yield tree
        for sub in tree:
            yield from tree_nodes(sub)


# ---------------------------------------------------------------------------
# hallway-door intermediate goals (human_plus.get_g_xy)
# ---------------------------------------------------------------------------

def intermediate_goals(pos, final_goal, door: DoorParams):
    """When the path to the final goal crosses the hallway door band, aim
    for the door middle until within door_width/2 of it. ``pos`` and
    ``final_goal`` are (*B, A, 2) for A agents, ``door`` has leading axes
    B."""
    door = DoorParams(*[x[..., None] for x in door])
    ys_min = torch.minimum(pos[..., 1], final_goal[..., 1])
    ys_max = torch.maximum(pos[..., 1], final_goal[..., 1])
    crosses = (ys_min < door.y_mid_min) & (ys_max > door.y_mid_max)
    shape = pos[..., 0].shape
    int_goal = torch.stack(
        [door.x_mid.expand(shape),
         (0.5 * (door.y_min + door.y_max)).expand(shape)], dim=-1)
    near_door = norm2(int_goal - pos) <= door.width / 2.0
    use_int = door.has_door & crosses & ~near_door
    return torch.where(use_int[..., None], int_goal, final_goal)


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

def _robot_next(state: SimState, action, cfg: EnvConfig):
    """Robot next position under the (already clamped) action."""
    if cfg.robot_kinematics == "holonomic":
        return state.r_pos + action * cfg.dt
    heading = state.r_theta + action[..., 1]
    return state.r_pos + action[..., 0, None] * cfg.dt * torch.stack(
        [torch.cos(heading), torch.sin(heading)], dim=-1)


def _term(enabled, detailed):
    return (enabled is not None) or detailed


def step(state: SimState, action: torch.Tensor, cfg: EnvConfig
         ) -> Tuple[SimState, torch.Tensor, StepInfo]:
    """One environment step. ``action`` is (..., 2): (vx, vy) for a
    holonomic robot or (v, r) for a unicycle robot, with the state's leading
    episode axes. Returns (next_state, reward, info).
    """
    h_act = human_actions(state, cfg)                      # (..., H, 2)
    return step_with_human_actions(state, action, h_act, cfg)


def step_with_human_actions(state: SimState, action: torch.Tensor,
                            h_act: torch.Tensor, cfg: EnvConfig
                            ) -> Tuple[SimState, torch.Tensor, StepInfo]:
    """Step with precomputed (unclamped) human actions."""
    rc = cfg.rewards
    dt = cfg.dt
    H = cfg.max_humans
    lead = state.t.shape
    zero = torch.zeros(lead, dtype=torch.float32, device=action.device)
    true = torch.ones(lead, dtype=torch.bool, device=action.device)

    # --- 2. clamp every human action against the walls --------------------
    h_act, _ = clamp_holonomic_action(state.h_pos, h_act, state.h_radius, dt,
                                      state.walls, state.wall_mask)

    # --- 3. clamp robot action; wall-collision flag -----------------------
    if cfg.robot_kinematics == "holonomic":
        r_act, stat_collision = clamp_holonomic_action(
            state.r_pos, action, state.r_radius, dt, state.walls,
            state.wall_mask)
    else:
        v_c, stat_collision = clamp_unicycle_action(
            state.r_pos, state.r_theta, action[..., 0], action[..., 1],
            state.r_radius, dt, state.walls, state.wall_mask)
        r_act = torch.stack([v_c, action[..., 1]], dim=-1)

    # --- 4. robot-human collision + dmin (sequential-break parity) --------
    r_next = _robot_next(state, r_act, cfg)
    h_next = state.h_pos + h_act * dt
    dists = norm2(r_next[..., None, :] - h_next)           # (..., H)
    r_sum = state.r_radius[..., None] + state.h_radius
    colliding = state.h_mask & (dists < r_sum)
    collision = colliding.any(dim=-1)
    # first colliding slot
    first_coll = torch.argmax(colliding.to(torch.uint8), dim=-1)
    slots = torch.arange(H, device=action.device)
    before_first = slots < torch.where(collision, first_coll, H)[..., None]
    dmin = torch.where(state.h_mask & before_first, dists,
                       torch.full_like(dists, math.inf)).amin(dim=-1)

    # --- 5. events --------------------------------------------------------
    if cfg.robot_kinematics == "holonomic":
        speed = norm2(r_act)
        frozen = speed * dt < 0.01
        curr_ang = torch.atan2(r_act[..., 1], r_act[..., 0])
        curr_lin = speed
    else:
        frozen = (r_act[..., 0] * dt).abs() < 0.01
        curr_ang = r_act[..., 1]
        curr_lin = r_act[..., 0]

    reached_goal = norm2(r_next - state.r_goal) < state.r_radius
    curr_dist_to_goal = norm2(state.r_goal - r_next)

    # --- 6. rewards -------------------------------------------------------
    det = cfg.detailed_reward
    reward = zero

    r_success = torch.where(reached_goal, rc.success_reward or 0.0, 0.0) \
        if _term(rc.success_reward, det) else zero
    done = reached_goal if rc.success_reward is not None or det else ~true

    timed_out = (~done) & (state.t >= cfg.time_limit)
    r_timeout = torch.where(timed_out, rc.timeout or 0.0, 0.0) \
        if _term(rc.timeout, det) else zero
    done = done | (~done & (state.t >= cfg.time_limit))

    if rc.success_reward is not None:
        reward = reward + r_success
    if rc.timeout is not None:
        reward = reward + torch.where(timed_out, rc.timeout, 0.0)

    r_collision = torch.where(collision, rc.collision_penalty or 0.0, 0.0) \
        if _term(rc.collision_penalty, det) else zero
    if rc.collision_penalty is not None:
        reward = reward + r_collision

    r_wall = torch.where(stat_collision, rc.wall_collision_penalty or 0.0, 0.0) \
        if _term(rc.wall_collision_penalty, det) else zero
    if rc.wall_collision_penalty is not None:
        reward = reward + r_wall

    danger = dmin < rc.discomfort_dist
    r_danger = torch.where(
        danger, (dmin - rc.discomfort_dist) *
        (rc.discomfort_penalty_factor or 0.0) * dt, zero) \
        if (rc.discomfort or det) else zero
    if rc.discomfort:
        reward = reward + r_danger

    r_progress = ((state.prev_dist_to_goal - curr_dist_to_goal) *
                  (rc.progress_factor or 0.0)) \
        if _term(rc.progress_factor, det) else zero
    if rc.progress_factor is not None:
        reward = reward + r_progress

    r_freezing = torch.where(frozen, rc.freezing_penalty or 0.0, 0.0) \
        if _term(rc.freezing_penalty, det) else zero
    if rc.freezing_penalty is not None:
        reward = reward + r_freezing

    # angular smoothness: |diff| * factor; unicycle "diff" is r*dt
    if cfg.robot_kinematics == "holonomic":
        ang_diff = (curr_ang - state.prev_ang).abs()
    else:
        ang_diff = curr_ang * dt
    r_angular = torch.where(
        state.has_prev_ang,
        ang_diff.abs() * (rc.angular_smoothness_factor or 0.0), zero) \
        if _term(rc.angular_smoothness_factor, det) else zero
    if rc.angular_smoothness_factor is not None:
        reward = reward + r_angular

    r_linear = torch.where(
        state.has_prev_lin,
        (state.prev_lin - curr_lin).abs() * (rc.linear_smoothness_factor or 0.0),
        zero) if _term(rc.linear_smoothness_factor, det) else zero
    if rc.linear_smoothness_factor is not None:
        reward = reward + r_linear

    info = StepInfo(
        reach_goal=reached_goal, timeout=timed_out, collision=collision,
        wall_collision=stat_collision, frozen=frozen, danger=danger, dmin=dmin,
        r_success=r_success, r_timeout=r_timeout, r_collision=r_collision,
        r_wall=r_wall, r_danger=r_danger, r_progress=r_progress,
        r_freezing=r_freezing, r_angular=r_angular, r_linear=r_linear,
        total_reward=reward, done=done)

    # --- 7. integrate -----------------------------------------------------
    if cfg.robot_kinematics == "holonomic":
        new_theta = torch.atan2(r_act[..., 1], r_act[..., 0])
        new_vel = r_act
        new_omega = zero
    else:
        new_theta = wrap_angle(state.r_theta + r_act[..., 1])
        new_vel = r_act[..., 0, None] * torch.stack(
            [torch.cos(new_theta), torch.sin(new_theta)], dim=-1)
        new_omega = r_act[..., 1] / dt

    h_theta = torch.atan2(h_act[..., 1], h_act[..., 0])
    new_h_goal = intermediate_goals(h_next, state.h_final_goal, state.door)

    # human arrival times (first arrival only)
    h_arrived = norm2(h_next - new_h_goal) < state.h_radius
    new_human_times = torch.where(
        (state.human_times == 0.0) & h_arrived & state.h_mask,
        (state.t + dt)[..., None], state.human_times)

    track_progress = rc.progress_factor is not None or det
    new_state = state._replace(
        r_pos=r_next, r_vel=new_vel, r_theta=new_theta, r_omega=new_omega,
        h_pos=h_next, h_vel=h_act, h_theta=h_theta, h_goal=new_h_goal,
        t=state.t + dt, step_idx=state.step_idx + 1,
        prev_dist_to_goal=(curr_dist_to_goal if track_progress
                           else state.prev_dist_to_goal),
        prev_ang=curr_ang, has_prev_ang=true,
        prev_lin=curr_lin, has_prev_lin=true,
        human_times=new_human_times,
        done=state.done | done)

    return new_state, reward, info


def _lead_where(cond, a, b):
    """``torch.where`` with ``cond`` on the leading (episode) axes of
    ``a`` and ``b``."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())),
                       a, b)


@tracing.spanned("env.step")
def step_masked(state: SimState, action, cfg: EnvConfig):
    """Step that freezes terminated environments."""
    new_state, reward, info = step(state, action, cfg)
    keep = state.done
    frozen_state = tree_map(lambda old, new: _lead_where(keep, old, new),
                            state, new_state)
    reward = torch.where(keep, 0.0, reward)
    info = tree_map(lambda x: torch.where(keep, torch.zeros_like(x), x), info)
    return frozen_state, reward, info


# ---------------------------------------------------------------------------
# reset
# ---------------------------------------------------------------------------

def _base_state(cfg: EnvConfig, walls, wall_mask, door, h_arrays,
                device) -> SimState:
    h_pos, h_goal, h_theta, h_radius, h_v_pref, h_mask = [
        torch.as_tensor(x, device=device) for x in h_arrays]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    door_t = DoorParams(*[torch.as_tensor(np.asarray(x), device=device)
                          for x in door])
    H = cfg.max_humans
    false = torch.zeros((), dtype=torch.bool, device=device)
    return SimState(
        r_pos=f32([0.0, -cfg.circle_radius]), r_vel=f32([0.0, 0.0]),
        r_theta=f32(np.pi / 2), r_omega=f32(0.0),
        r_goal=f32([0.0, cfg.circle_radius]), r_radius=f32(cfg.robot_radius),
        r_v_pref=f32(cfg.robot_v_pref),
        h_pos=h_pos, h_vel=torch.zeros((H, 2), dtype=torch.float32, device=device),
        h_theta=h_theta, h_goal=intermediate_goals(h_pos, h_goal, door_t),
        h_final_goal=h_goal, h_radius=h_radius, h_v_pref=h_v_pref,
        h_mask=h_mask,
        walls=torch.as_tensor(walls, device=device),
        wall_mask=torch.as_tensor(wall_mask, device=device),
        door=door_t,
        t=f32(0.0), step_idx=torch.zeros((), dtype=torch.int32, device=device),
        prev_dist_to_goal=f32(2.0 * cfg.circle_radius),
        prev_ang=f32(0.0), has_prev_ang=false,
        prev_lin=f32(0.0), has_prev_lin=false,
        human_times=torch.zeros((H,), dtype=torch.float32, device=device),
        done=false)


def _dummy_prestep(state: SimState, cfg: EnvConfig) -> SimState:
    """``starts_moving`` pre-roll: step humans with a zero robot action,
    then reset the reward trackers."""
    n = cfg.starts_moving
    if n <= 0:
        return state
    state = state._replace(t=torch.full_like(state.t, -n * cfg.dt),
                           step_idx=torch.full_like(state.step_idx, -n))
    zero_action = torch.zeros_like(state.r_pos)
    for _ in range(n):
        state, _, _ = step(state, zero_action, cfg)
    false = torch.zeros_like(state.done)
    return state._replace(
        has_prev_ang=false, has_prev_lin=false,
        prev_dist_to_goal=norm2(state.r_goal - state.r_pos), done=false)


def reset_host(cfg: EnvConfig, case: int, phase: str = "test",
               device=None) -> SimState:
    """Deterministic seeded reset matching the reference evaluation protocol
    (case index == RNG seed). Runs on CUDA unless ``device`` names another
    device."""
    device = resolve_device(device)
    walls, wall_mask, door = walls_mod.build_walls(cfg)
    h_arrays = scenarios.generate_host(cfg, case, phase, walls, wall_mask)
    state = _base_state(cfg, walls, wall_mask, door, h_arrays, device)
    return _dummy_prestep(state, cfg)


def stack(trees):
    """NamedTuples of tensors stacked on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def reset_batch(cfg: EnvConfig, cases, phase: str = "test",
                device=None) -> SimState:
    """``reset_host`` of every case in ``cases``, stacked on a leading
    episode axis (case == seed, as for one episode)."""
    return stack([reset_host(cfg, c, phase, device) for c in cases])


def reset_device(cfg: EnvConfig, n: int, generator=None, device=None,
                 draws=None, base: SimState = None) -> SimState:
    """n resets drawn on the device (``scenarios.generate_device``) as one
    state with a leading episode axis: the reference's ``reset_device``
    vmapped over n keys. Draws come from ``generator`` (on ``device``) or
    are handed in as ``draws``. Runs on CUDA unless ``device`` names
    another device.

    ``base``, an earlier ``reset_device`` of n episodes of ``cfg``, gives
    the fields that no draw decides (robot, walls, door, trackers), so
    that the call copies nothing from the host and the host never waits
    for the card; its human fields are drawn anew."""
    if base is None:
        device = resolve_device(device)
        walls, wall_mask, door = walls_mod.build_walls(cfg)
        walls_t = torch.as_tensor(walls, device=device)
        wall_mask_t = torch.as_tensor(wall_mask, device=device)
    else:
        walls_t, wall_mask_t = base.walls[0], base.wall_mask[0]
    h_arrays = scenarios.generate_device(cfg, n, walls_t, wall_mask_t,
                                         generator, draws)
    h_pos, h_goal, h_theta, h_radius, h_v_pref, h_mask = h_arrays
    if base is None:
        one = _base_state(cfg, walls, wall_mask, door,
                          [x[0] for x in h_arrays], device)
        base = tree_map(lambda x: x.expand(n, *x.shape).clone(), one)
    state = base._replace(
        h_pos=h_pos, h_vel=torch.zeros_like(h_pos), h_theta=h_theta,
        h_goal=intermediate_goals(h_pos, h_goal, base.door),
        h_final_goal=h_goal, h_radius=h_radius, h_v_pref=h_v_pref,
        h_mask=h_mask, human_times=torch.zeros_like(h_radius))
    return _dummy_prestep(state, cfg)


# ---------------------------------------------------------------------------
# observation helpers
# ---------------------------------------------------------------------------

def observable_human_states(state: SimState):
    """(..., H, 5) [px, py, vx, vy, radius] and the (..., H) mask: the
    reference's ObservableState list observation."""
    return torch.cat([state.h_pos, state.h_vel, state.h_radius[..., None]],
                     dim=-1), state.h_mask


def full_human_states(state: SimState):
    """(..., H, 9) [px, py, vx, vy, radius, gx, gy, v_pref, theta] and the
    (..., H) mask."""
    return torch.cat([state.h_pos, state.h_vel, state.h_radius[..., None],
                      state.h_goal, state.h_v_pref[..., None],
                      state.h_theta[..., None]], dim=-1), state.h_mask


def robot_full_state(state: SimState):
    """(..., 9) [px, py, vx, vy, radius, gx, gy, v_pref, theta]."""
    return torch.cat([state.r_pos, state.r_vel, state.r_radius[..., None],
                      state.r_goal, state.r_v_pref[..., None],
                      state.r_theta[..., None]], dim=-1)

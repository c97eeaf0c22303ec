"""Exact static-obstacle action clamping (twin of
``sicnav_tpu/env/wall_clamp.py``).

An agent's action is shortened so its swept disk cannot penetrate any wall
segment (reference ``CrowdSimPlus.constrain_agent_action_exact``).
Candidates are computed for every agent and wall at once and reduced by
smallest displacement, which reproduces the reference's sequential "keep
the slower candidate" loop.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen.ops.geometry import (
    closest_point_on_line, dot2, line_intersection, norm2, seg_seg_closest,
)

_EPS_TOUCH = 1e-4
_EPS_DIR = 1e-8


def _final_position_vs_wall(cur, fut, radius, w0, w1):
    """Candidate constrained final position of agents against walls; all
    arguments broadcast (points (..., 2), radius (...)). Returns
    (final_pos (..., 2), collides (...))."""
    movement = fut - cur
    movement_mag = norm2(movement)

    pA, pB, closest_distance = seg_seg_closest(w0, w1, cur, fut)
    collides = closest_distance - radius < 0.0

    # ---- case split: end-point vs interior -------------------------------
    at_endpoint = (torch.minimum(norm2(pA - w0), norm2(pA - w1)) < _EPS_DIR) & \
        (norm2(pA - pB) > _EPS_DIR)

    # ---- end-point (corner) case -----------------------------------------
    direction_vec = pB - cur
    dir_mag = norm2(direction_vec)
    safe_dir_mag = torch.clamp(dir_mag, min=_EPS_DIR)
    unit_dir = direction_vec / safe_dir_mag[..., None]

    touching = (norm2(pA - cur) - radius < _EPS_TOUCH) & \
        (dot2(movement, pA - cur) > -_EPS_DIR)

    cd = torch.clamp(closest_distance, min=_EPS_DIR)
    arccos_val = -dot2(direction_vec, pA - pB) / (safe_dir_mag * cd)
    head_on = arccos_val <= -1.0          # alpha == pi after clipping
    alpha = torch.arccos(torch.clamp(arccos_val, -1.0, 1.0))
    sin_alpha = torch.clamp(torch.sin(alpha), min=_EPS_DIR)
    gamma = torch.arcsin(torch.clamp(
        cd * torch.sin(alpha) / torch.clamp(radius, min=_EPS_DIR), -1.0, 1.0))
    beta = math.pi - alpha - gamma
    redux_triangle = radius * torch.sin(beta) / sin_alpha + 1e-7
    redux_head_on = radius - closest_distance

    redux = torch.where(touching, dir_mag,
                        torch.where(head_on, redux_head_on, redux_triangle))
    redux = torch.where(dir_mag > 0.0, redux, torch.zeros_like(redux))
    final_corner = cur + unit_dir * torch.clamp(dir_mag - redux, min=0.0)[..., None]

    # ---- interior (infinite line) case -----------------------------------
    cl = closest_point_on_line(w0, w1, cur)
    touching_line = (norm2(cl - cur) - radius < _EPS_TOUCH) & \
        (dot2(movement, cl - cur) > -_EPS_DIR)
    inter = line_intersection(cur, movement, w0, w1)
    d_vec = inter - cur
    dc0 = torch.clamp(norm2(cur - cl), min=_EPS_DIR)
    scaling = torch.clamp((dc0 - (radius + 1e-7)) / dc0, min=0.0)
    cur_b = cur.expand_as(d_vec)
    final_line = torch.where(
        (movement_mag > 0.0)[..., None],
        torch.where(touching_line[..., None], cur_b,
                    cur + d_vec * scaling[..., None]),
        cur_b)

    final = torch.where(at_endpoint[..., None], final_corner, final_line)
    return final, collides


def clamp_action_positions(cur, fut, radius, walls, wall_mask):
    """Clamp the motions ``cur -> fut`` of agents of ``radius`` against all
    walls: the candidate with the smallest displacement.

    Shapes: cur, fut (*B, *A, 2); radius (*B, *A); walls (*B, W, 2, 2);
    wall_mask (*B, W), with B the leading episode axes (none for one
    episode) and A the agent axes. Returns (final (*B, *A, 2), clamped
    (*B, *A)).
    """
    lead = walls.shape[:-3]
    n_agent = cur.dim() - 1 - len(lead)
    walls = walls.reshape(*lead, *(1,) * n_agent, *walls.shape[-3:])
    wall_mask = wall_mask.reshape(*lead, *(1,) * n_agent, wall_mask.shape[-1])
    cur_, fut_ = cur[..., None, :], fut[..., None, :]
    finals, collides = _final_position_vs_wall(
        cur_, fut_, radius[..., None], walls[..., 0, :], walls[..., 1, :])
    active = collides & wall_mask
    disp = norm2(finals - cur_)
    disp = torch.where(active, disp, torch.full_like(disp, math.inf))
    best = torch.argmin(disp, dim=-1, keepdim=True)
    chosen = torch.gather(
        finals, -2, best[..., None].expand(*best.shape, 2)).squeeze(-2)
    any_active = active.any(dim=-1)
    return torch.where(any_active[..., None], chosen, fut), any_active


def clamp_holonomic_action(pos, vel_action, radius, dt, walls, wall_mask):
    """ActionXY clamping of agents (..., 2): returns ((vx, vy) of the
    constrained action, changed)."""
    fut = pos + vel_action * dt
    final, clamped = clamp_action_positions(pos, fut, radius, walls, wall_mask)
    new_vel = (final - pos) / dt
    # keep whichever action is slower
    keep_new = dot2(new_vel, new_vel) < dot2(vel_action, vel_action)
    out = torch.where((clamped & keep_new)[..., None], new_vel, vel_action)
    # the reference detects a wall collision by comparing vx only
    changed = out[..., 0] != vel_action[..., 0]
    return out, changed


def clamp_unicycle_action(pos, theta, v, r, radius, dt, walls, wall_mask):
    """ActionRot clamping: returns (v', changed) with the same rotation but
    the speed shortened, sign-aware."""
    heading = theta + r
    fut = pos + v[..., None] * dt * torch.stack(
        [torch.cos(heading), torch.sin(heading)], dim=-1)
    final, clamped = clamp_action_positions(pos, fut, radius, walls, wall_mask)
    mag = norm2(final - pos) / dt
    v_new = torch.where(v > 0.0, mag, -mag)
    keep_new = torch.where(v > 0.0, v_new < v, v_new > v)
    v_out = torch.where(clamped & keep_new, v_new, v)
    return v_out, v_out != v

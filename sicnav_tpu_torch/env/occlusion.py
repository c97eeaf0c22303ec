"""Robocentric transforms and field-of-view occlusion (twin of
``sicnav_tpu/env/occlusion.py``).

``robocentric_state`` (the robot's heading frame), ``robocentric_goal_
aligned`` (the goal-aligned frame of the SB3-form arrays) and
``occlusion_mask`` (nearer humans hide farther ones), on states and
positions with optional leading episode axes.

Occlusion is measured on the reference's fixed angular grid: each human's
subtended arc (half-width arctan(r / d)) is rasterized into ``n_bins``
bins, and a human stays visible while at least ``VISIBLE_THRESHOLD`` of
its own bins are not covered by a nearer human. The reference's scan over
the humans in distance order becomes a cumulative OR over the sorted rows,
shifted by one: the bins the nearer humans cover.
"""

from __future__ import annotations

import math

import torch

from sicnav_tpu_torch.env.types import SimState
from sicnav_tpu_torch.ops.geometry import wrap_angle

VISIBLE_THRESHOLD = 0.75     # the reference's 75 % rule


def _rot(theta, v):
    """Rotate points ``v`` (..., [N, ...,] 2) by -theta (...)."""
    th = theta.reshape(theta.shape + (1,) * (v.dim() - 1 - theta.dim()))
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([c * v[..., 0] + s * v[..., 1],
                        -s * v[..., 0] + c * v[..., 1]], dim=-1)


def _shift(p, t):
    """``p`` (..., [N, ...,] 2) minus the origin ``t`` (..., 2)."""
    return p - t.reshape(t.shape[:-1] + (1,) * (p.dim() - t.dim()) + (2,))


def robocentric_state(state: SimState) -> SimState:
    """World -> robot heading frame: the robot sits at the origin with
    theta = 0; positions translate and rotate, velocities rotate, walls
    transform end point by end point."""
    t = state.r_pos
    th = state.r_theta

    def tsf(p):
        return _rot(th, _shift(p, t))

    def rot(v):
        return _rot(th, v)

    return state._replace(
        r_pos=torch.zeros_like(state.r_pos),
        r_goal=tsf(state.r_goal),
        r_vel=rot(state.r_vel),
        r_theta=torch.zeros_like(state.r_theta),
        h_pos=tsf(state.h_pos),
        h_vel=rot(state.h_vel),
        h_goal=tsf(state.h_goal),
        h_theta=wrap_angle(state.h_theta - th[..., None]),
        walls=tsf(state.walls))


def robocentric_goal_aligned(state: SimState):
    """World -> goal-aligned robot frame: +x points at the goal, the robot
    at the origin. Returns (robot (..., 9), humans (..., H, 5)) in the
    SB3 array form [px, py, vx, vy, r, gx, gy, v_pref, theta] /
    [px, py, vx, vy, r]."""
    t = state.r_pos
    rot_amount = torch.atan2(state.r_goal[..., 1] - t[..., 1],
                             state.r_goal[..., 0] - t[..., 0])

    def tsf(p):
        return _rot(rot_amount, _shift(p, t))

    def rot(v):
        return _rot(rot_amount, v)

    g = tsf(state.r_goal)
    v = rot(state.r_vel)
    robot = torch.cat([
        torch.zeros_like(t), v, state.r_radius[..., None], g,
        state.r_v_pref[..., None],
        wrap_angle(state.r_theta - rot_amount)[..., None]], dim=-1)
    humans = torch.cat([tsf(state.h_pos), rot(state.h_vel),
                        state.h_radius[..., None]], dim=-1)
    return robot, humans


def occlusion_mask(h_pos_rc, h_radius, h_mask, n_bins: int = 720):
    """Visibility of each human from the (robot-frame) origin.
    ``h_pos_rc``: (..., H, 2) robot-frame positions, ``h_radius`` and
    ``h_mask`` (..., H). Returns (..., H) bool, True where the human is not
    occluded by a nearer one. Masked-out humans neither occlude nor count
    as visible."""
    d = torch.linalg.norm(h_pos_rc, dim=-1)
    ang = torch.atan2(h_pos_rc[..., 1], h_pos_rc[..., 0])
    half = torch.atan2(h_radius, torch.clamp(d, min=1e-6))

    # each human's subtended arc rasterized into angular bins, wrap-safe
    centers = (torch.arange(n_bins, dtype=h_pos_rc.dtype,
                            device=h_pos_rc.device) + 0.5) / n_bins * 2 * \
        math.pi - math.pi
    delta = wrap_angle(centers - ang[..., None])             # (..., H, n)
    occupied = (delta.abs() <= half[..., None]) & h_mask[..., None]

    # nearest first; masked humans last
    order = torch.argsort(torch.where(h_mask, d, torch.full_like(d, math.inf)),
                          dim=-1, stable=True)
    occ = torch.gather(occupied, -2,
                       order[..., None].expand(occupied.shape))
    # the bins covered by the humans nearer than each one
    covered = (torch.cumsum(occ.to(torch.int32), dim=-2) -
               occ.to(torch.int32)) > 0
    n_own = occ.sum(dim=-1)
    own = torch.clamp(n_own, min=1)
    free = (occ & ~covered).sum(dim=-1)
    # a human so distant its arc rasterizes to zero bins is visible (the
    # reference's interval clipping never hides an empty interval)
    vis_sorted = (n_own == 0) | ((free / own) >= VISIBLE_THRESHOLD)
    visible = torch.zeros_like(h_mask).scatter(-1, order, vis_sorted)
    return visible & h_mask


def observable_humans(state: SimState, n_bins: int = 720):
    """The occlusion mask in the robot's frame of the raw world state (the
    mask does not depend on the frame's rotation)."""
    rel = _shift(state.h_pos, state.r_pos)
    return occlusion_mask(rel, state.h_radius, state.h_mask, n_bins)

"""Differentiable ORCA half-planes of the MPC's internal human model (twin
of ``sicnav_tpu/mpc/orca_lines.py``).

Pairwise velocity-obstacle lines with the smoothed already-in-collision
case, per-wall static lines, preferred velocities, and the "checked"
invalidation that moves a line that cannot be active (outside the
|v| <= V_MAX_CHECK disk) onto a harmless dummy line, so the constraint
count stays fixed. Every function is a ``torch.where`` chain on the
trailing axes that broadcasts over leading batch dimensions (where the
reference is written for one pair under ``vmap``), and is safe under
``torch.func`` transforms: no in-place writes, no host reads.

Half-plane convention: constraint on human A's velocity v is
``line_norm . v >= line_scalar``  <=>  ``-line_norm . v + line_scalar <= 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sicnav_tpu_torch.ops.geometry import det2, dot2, jabs, jmax
from sicnav_tpu_torch.ops.orca import edge_orca_line

# invalidation bound: a line outside the |v| <= V_MAX_CHECK disk cannot be
# active; it is replaced with a dummy line
V_MAX_CHECK = 2.0
DUMMY_SCALE = -1.15 * V_MAX_CHECK


class OrcaModelParams(NamedTuple):
    """MPC-internal ORCA parameters."""
    time_horizon: float = 2.5        # time_coll_hor
    time_horizon_obst: float = 1.5   # time_coll_hor_obst
    dt: float = 0.25
    radius_buffer: float = 0.01      # added to radii (+ safety_space)
    safety_space: float = 0.01


def _where2(cond, a, b):
    return torch.where(cond[..., None], a, b)


def _perp(v):
    """(v_y, -v_x)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def _normal(line_dir):
    """(-d_y, d_x): the line's normal, pointing into the feasible side."""
    return torch.stack([-line_dir[..., 1], line_dir[..., 0]], dim=-1)


def pairwise_line(pos_a, vel_a, pos_b, vel_b, rad_a, rad_b,
                  params: OrcaModelParams):
    """ORCA_{A|B} half-plane (norm (..., 2), scalar (...)) for agent A vs
    agent B. The no-collision branch is the standard VO projection; the
    in-collision branch is the smoothed 'protrusion' cutoff line (not the
    exact RVO2 push-apart), kept for solver conditioning."""
    rel_pos = pos_b - pos_a
    rel_vel = vel_a - vel_b
    dist_sq = jmax(dot2(rel_pos, rel_pos), 1e-12)
    comb_rad = rad_a + rad_b
    comb_rad_sq = comb_rad ** 2

    inv_th = 1.0 / params.time_horizon
    w = rel_vel - inv_th * rel_pos
    w_len_sq = dot2(w, w)
    dot1 = dot2(w, rel_pos)
    on_cutoff = (dot1 < 0.0) & (dot1 * dot1 > comb_rad_sq * w_len_sq)

    w_len = torch.sqrt(jmax(w_len_sq, 1e-18))
    unit_w = w / w_len[..., None]
    dir_cut = _perp(unit_w)
    u_cut = (comb_rad * inv_th - w_len)[..., None] * unit_w

    leg = torch.sqrt(jmax(jabs(dist_sq - comb_rad_sq), 0.0))
    rx, ry = rel_pos[..., 0], rel_pos[..., 1]
    d_left = torch.stack([rx * leg - ry * comb_rad,
                          rx * comb_rad + ry * leg], dim=-1) / dist_sq[..., None]
    d_right = -torch.stack([rx * leg + ry * comb_rad,
                            -rx * comb_rad + ry * leg], dim=-1) / dist_sq[..., None]
    dir_leg = _where2(det2(rel_pos, w) > 0.0, d_left, d_right)
    u_leg = dot2(rel_vel, dir_leg)[..., None] * dir_leg - rel_vel

    dir_nc = _where2(on_cutoff, dir_cut, dir_leg)
    u_nc = _where2(on_cutoff, u_cut, u_leg)

    # in collision: the smoothed protrusion cutoff line
    inv_ts = 1.0 / params.dt
    rel_dist = torch.sqrt(jmax(dist_sq, 1e-18))
    unit_rel = rel_pos / rel_dist[..., None]
    protrusion = comb_rad - rel_dist
    norm_c = -unit_rel
    dir_c = _perp(norm_c)
    cut_pt = inv_ts * (protrusion ** 2)[..., None] * norm_c
    proj_pt = cut_pt + dot2(rel_vel - cut_pt, dir_c)[..., None] * dir_c
    u_c = proj_pt - rel_vel

    no_coll = dist_sq > comb_rad_sq
    line_dir = _where2(no_coll, dir_nc, dir_c)
    u = _where2(no_coll, u_nc, u_c)

    line_pt = vel_a + 0.5 * u
    line_norm = _normal(line_dir)
    return line_norm, _checked_scalar(line_norm, line_dir, line_pt)


def _checked_scalar(line_norm, line_dir, line_pt):
    dp = dot2(line_dir, line_pt)
    disc = dp * dp + V_MAX_CHECK ** 2 - dot2(line_pt, line_pt)
    scalar = dot2(line_norm, line_pt)
    dummy = dot2(line_norm, DUMMY_SCALE * line_norm)
    return torch.where(disc < 0.0, dummy, scalar)


def static_line(pos_a, vel_a, rad_a, wall, wall_valid,
                params: OrcaModelParams):
    """Per-wall static-obstacle ORCA half-plane for agent A: the directed
    edge visible from the agent's side, its VO line from the shared edge
    geometry (``ops.orca.edge_orca_line``), and invalid lines (or lines
    beyond the velocity bound) collapsed onto the far dummy line.
    ``wall`` is (..., 2, 2), ``wall_valid`` (...)."""
    p1, p2 = wall[..., 0, :], wall[..., 1, :]
    # visible orientation: agent strictly right of the directed edge
    flip = det2(p2 - p1, pos_a - p1) >= 0.0
    e1 = _where2(flip, p2, p1)
    e2 = _where2(flip, p1, p2)
    pt, line_dir, valid = edge_orca_line(pos_a, vel_a, rad_a, e1, e2,
                                         1.0 / params.time_horizon_obst)
    line_norm = _normal(line_dir)
    scalar = _checked_scalar(line_norm, line_dir, pt)
    dummy = dot2(line_norm, DUMMY_SCALE * line_norm)
    scalar = torch.where(valid & wall_valid, scalar, dummy)
    # a sane norm even for invalid lines: (0, 1), made on the device (a
    # constant copied from the host would wait for it at every evaluation)
    up = torch.cat([torch.zeros_like(line_norm[..., :1]),
                    torch.ones_like(line_norm[..., 1:])], dim=-1)
    line_norm = _where2(torch.isnan(line_norm).any(dim=-1), up, line_norm)
    return line_norm, scalar


def v_pref_from_state(pos, goal, v_max):
    """Preferred velocity toward the goal: the raw goal displacement,
    rescaled to (v_max - 1e-3) when its magnitude >= v_max. pos, goal
    (..., 2); v_max (...)."""
    v = goal - pos
    mag = torch.sqrt(jmax(dot2(v, v), 0.0)) + 0.001
    v_capped = v / mag[..., None] * (v_max - 1e-3)[..., None]
    return _where2(mag >= v_max, v_capped, v)


def lower_level_cost(v, ksi, v_pref):
    """Human A's relaxed-ORCA objective: ||v - v_pref||^2 + 100 ksi^2."""
    d = v - v_pref
    return dot2(d, d) + 100.0 * ksi ** 2

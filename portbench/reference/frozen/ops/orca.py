"""Batched ORCA (twin of ``sicnav_tpu/ops/orca.py``).

The published ORCA algorithm (van den Berg, Guy, Lin, Manocha, "Reciprocal
n-body collision avoidance", ISRR 2011): agent and static-edge velocity
obstacle half-planes and the incremental 2D linear program with its
infeasibility fallback (LP3). Every function takes a leading batch of acting
agents where the reference is written for one agent under ``vmap``; all
shapes are fixed and branches are masks.

The reference's sequential loops are split where the data allows it, so an
eager GPU run makes hundreds of small launches per call instead of ~10^4:

- RVO2's linearProgram1 for line ``i`` does not read the running result, so
  ``_lp1_all`` solves it for every line at once; the sequential part of
  ``_lp2`` is then only the violation test and the select.
- LP3's inner LP2 for each line ``i`` starts from ``opt * radius`` and reads
  only the lines, so all of them run as one batched ``_lp2``; the sequential
  part of ``_lp3`` is the select over ``i``.
- Obstacle lines do not depend on each other; only RVO2's already-covered
  pruning is sequential, and it reads the lines' points and directions,
  which are computed up front.

Each element still goes through the reference's arithmetic in the
reference's order, so results agree to float32 rounding.

Conventions: each ORCA line is (point, direction); the feasible half-plane
is ``{v : det(direction, point - v) <= 0}``. Walls are standalone 2-vertex
segments, each giving two directed edges.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.frozen.ops.geometry import (
    closest_point_on_segment, det2, dot2, jmax, norm2, normalize,
)

# RVO2's epsilon for LP degeneracy tests.
RVO_EPSILON = 1e-5
_BIG = 1e9


class OrcaParams(NamedTuple):
    """ORCA behavioural parameters (reference ORCA policy defaults)."""
    neighbor_dist: float = 10.0
    time_horizon: float = 2.0
    time_horizon_obst: float = 0.5
    dt: float = 0.25


def _perp_cw(v):
    """(v_y, -v_x): ``v`` turned clockwise by a right angle."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


def _where2(cond, a, b):
    """``torch.where`` for (..., 2) vectors under a (...) condition."""
    return torch.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# Half-plane construction: agent pairs
# ---------------------------------------------------------------------------

def agent_orca_lines(pos, vel, rad, npos, nvel, nrad, nmask, time_horizon,
                     dt):
    """ORCA lines of acting agents vs. ``N`` padded neighbour slots each.

    Shapes: pos, vel (..., 2); rad (...); npos, nvel (..., N, 2); nrad,
    nmask (..., N). Returns (points (..., N, 2), dirs (..., N, 2),
    valid (..., N)).
    """
    inv_th = 1.0 / time_horizon
    inv_dt = 1.0 / dt
    vel_ = vel[..., None, :]

    rel_pos = npos - pos[..., None, :]
    rel_vel = vel_ - nvel
    dist_sq = torch.clamp(dot2(rel_pos, rel_pos), min=1e-12)
    comb_r = rad[..., None] + nrad
    comb_r_sq = comb_r * comb_r

    no_collision = dist_sq > comb_r_sq

    # --- no-collision case ------------------------------------------------
    w = rel_vel - inv_th * rel_pos
    w_len_sq = dot2(w, w)
    dot1 = dot2(w, rel_pos)
    on_cutoff = (dot1 < 0.0) & (dot1 * dot1 > comb_r_sq * w_len_sq)

    w_len = torch.sqrt(torch.clamp(w_len_sq, min=1e-18))
    unit_w = w / w_len[..., None]
    dir_cutoff = _perp_cw(unit_w)
    u_cutoff = (comb_r * inv_th - w_len)[..., None] * unit_w

    leg = torch.sqrt(torch.clamp(dist_sq - comb_r_sq, min=0.0))
    left = det2(rel_pos, w) > 0.0
    rx, ry = rel_pos[..., 0], rel_pos[..., 1]
    dir_left = torch.stack([rx * leg - ry * comb_r,
                            rx * comb_r + ry * leg], dim=-1) / dist_sq[..., None]
    dir_right = -torch.stack([rx * leg + ry * comb_r,
                              -rx * comb_r + ry * leg], dim=-1) / dist_sq[..., None]
    dir_leg = _where2(left, dir_left, dir_right)
    u_leg = dot2(rel_vel, dir_leg)[..., None] * dir_leg - rel_vel

    dir_nc = _where2(on_cutoff, dir_cutoff, dir_leg)
    u_nc = _where2(on_cutoff, u_cutoff, u_leg)

    # --- collision case ---------------------------------------------------
    w_c = rel_vel - inv_dt * rel_pos
    w_c_len = torch.sqrt(torch.clamp(dot2(w_c, w_c), min=1e-18))
    unit_w_c = w_c / w_c_len[..., None]
    dir_c = _perp_cw(unit_w_c)
    u_c = (comb_r * inv_dt - w_c_len)[..., None] * unit_w_c

    direction = _where2(no_collision, dir_nc, dir_c)
    u = _where2(no_collision, u_nc, u_c)

    # reciprocal: each agent takes half the responsibility
    points = vel_ + 0.5 * u
    return points, direction, nmask


# ---------------------------------------------------------------------------
# Half-plane construction: static line-segment obstacles
# ---------------------------------------------------------------------------

def edge_orca_line(pos, vel, rad, ep1, ep2, inv_th):
    """ORCA line of an acting agent vs. one directed obstacle edge (RVO2's
    obstacle VO construction minus the already-covered pruning), for
    standalone 2-vertex walls. All arguments broadcast: pos, vel, ep1, ep2
    (..., 2); rad (...). Returns (point (..., 2), direction (..., 2),
    valid (...))."""
    rp1 = ep1 - pos
    rp2 = ep2 - pos
    u_d = normalize(ep2 - ep1)
    r_sq = rad * rad
    shape = rp1.shape[:-1]
    rad = rad.expand(shape)

    d1_sq = dot2(rp1, rp1)
    d2_sq = dot2(rp2, rp2)
    ovec = ep2 - ep1
    ovec_sq = torch.clamp(dot2(ovec, ovec), min=1e-18)
    s = dot2(-rp1, ovec) / ovec_sq
    dline = -rp1 - s[..., None] * ovec
    dline_sq = dot2(dline, dline)

    # --- collision cases (point = 0) --------------------------------------
    coll_v1 = (s < 0.0) & (d1_sq <= r_sq)
    coll_v2 = (s > 1.0) & (d2_sq <= r_sq)
    coll_seg = (s >= 0.0) & (s <= 1.0) & (dline_sq <= r_sq)
    coll_v2_valid = det2(rp2, -u_d) >= 0.0
    dir_coll_v1 = normalize(torch.stack([-rp1[..., 1], rp1[..., 0]], dim=-1))
    dir_coll_v2 = normalize(torch.stack([-rp2[..., 1], rp2[..., 0]], dim=-1))
    dir_coll_seg = -u_d

    in_collision = coll_v1 | coll_v2 | coll_seg
    coll_valid = torch.where(coll_v1, torch.ones_like(coll_v1),
                             torch.where(coll_v2, coll_v2_valid, coll_seg))
    dir_coll = _where2(coll_v1, dir_coll_v1,
                       _where2(coll_v2, dir_coll_v2, dir_coll_seg))

    # --- no collision: leg directions -------------------------------------
    oblique1 = (s < 0.0) & (dline_sq <= r_sq)
    oblique2 = (s > 1.0) & (dline_sq <= r_sq)

    # jnp.maximum's derivative (geometry.jmax): inside the radius of an end
    # point the reference's second derivatives here are NaN, and the MPC
    # differentiates this function twice
    leg1 = torch.sqrt(jmax(d1_sq - r_sq, 0.0))
    leg2 = torch.sqrt(jmax(d2_sq - r_sq, 0.0))
    d1s = jmax(d1_sq, 1e-18)[..., None]
    d2s = jmax(d2_sq, 1e-18)[..., None]
    x1, y1 = rp1[..., 0], rp1[..., 1]
    x2, y2 = rp2[..., 0], rp2[..., 1]
    left1 = torch.stack([x1 * leg1 - y1 * rad, x1 * rad + y1 * leg1], -1) / d1s
    right1 = torch.stack([x1 * leg1 + y1 * rad, -x1 * rad + y1 * leg1], -1) / d1s
    left2 = torch.stack([x2 * leg2 - y2 * rad, x2 * rad + y2 * leg2], -1) / d2s
    right2 = torch.stack([x2 * leg2 + y2 * rad, -x2 * rad + y2 * leg2], -1) / d2s

    left_leg = _where2(oblique1, left1, _where2(oblique2, left2, left1))
    right_leg = _where2(oblique1, right1, _where2(oblique2, right2, right2))
    same_vertex = oblique1 | oblique2
    cut_l_pt = _where2(oblique2, rp2, rp1)
    cut_r_pt = _where2(oblique1, rp1, rp2)

    left_foreign = det2(left_leg, u_d) >= 0.0
    right_foreign = det2(right_leg, u_d) <= 0.0
    left_leg = _where2(left_foreign, u_d, left_leg)
    right_leg = _where2(right_foreign, u_d, right_leg)

    left_cutoff = inv_th * cut_l_pt
    right_cutoff = inv_th * cut_r_pt
    cutoff_vec = right_cutoff - left_cutoff
    cutoff_sq = torch.clamp(dot2(cutoff_vec, cutoff_vec), min=1e-18)

    t = torch.where(same_vertex, torch.full_like(s, 0.5),
                    dot2(vel - left_cutoff, cutoff_vec) / cutoff_sq)
    t_left = dot2(vel - left_cutoff, left_leg)
    t_right = dot2(vel - right_cutoff, right_leg)

    proj_left_circle = ((t < 0.0) & (t_left < 0.0)) | \
        (same_vertex & (t_left < 0.0) & (t_right < 0.0))
    proj_right_circle = (t > 1.0) & (t_right < 0.0)

    unit_w_l = normalize(vel - left_cutoff)
    unit_w_r = normalize(vel - right_cutoff)
    dir_lc = _perp_cw(unit_w_l)
    dir_rc = _perp_cw(unit_w_r)
    r_th = (rad * inv_th)[..., None]
    pt_lc = left_cutoff + r_th * unit_w_l
    pt_rc = right_cutoff + r_th * unit_w_r

    big = torch.full_like(s, _BIG)
    e_cut = vel - (left_cutoff + t[..., None] * cutoff_vec)
    e_left = vel - (left_cutoff + t_left[..., None] * left_leg)
    e_right = vel - (right_cutoff + t_right[..., None] * right_leg)
    d_cut = torch.where((t < 0.0) | (t > 1.0) | same_vertex, big,
                        dot2(e_cut, e_cut))
    d_left = torch.where(t_left < 0.0, big, dot2(e_left, e_left))
    d_right = torch.where(t_right < 0.0, big, dot2(e_right, e_right))

    use_cut = (d_cut <= d_left) & (d_cut <= d_right)
    use_left = (~use_cut) & (d_left <= d_right)

    dir_cutline = -u_d
    pt_cutline = left_cutoff + r_th * torch.stack(
        [-dir_cutline[..., 1], dir_cutline[..., 0]], dim=-1)
    pt_ll = left_cutoff + r_th * torch.stack(
        [-left_leg[..., 1], left_leg[..., 0]], dim=-1)
    dir_rl = -right_leg
    pt_rl = right_cutoff + r_th * _perp_cw(right_leg)

    nc_dir_pre = _where2(use_cut, dir_cutline, _where2(use_left, left_leg, dir_rl))
    nc_pt_pre = _where2(use_cut, pt_cutline, _where2(use_left, pt_ll, pt_rl))
    nc_valid = torch.where(use_cut, torch.ones_like(use_cut),
                           torch.where(use_left, ~left_foreign, ~right_foreign))
    # projection onto the cutoff circles takes priority over legs/cutline
    nc_dir = _where2(proj_left_circle, dir_lc,
                     _where2(proj_right_circle, dir_rc, nc_dir_pre))
    nc_pt = _where2(proj_left_circle, pt_lc,
                    _where2(proj_right_circle, pt_rc, nc_pt_pre))
    nc_valid = nc_valid | proj_left_circle | proj_right_circle

    direction = _where2(in_collision, dir_coll, nc_dir)
    point = _where2(in_collision, torch.zeros_like(nc_pt), nc_pt)
    valid = torch.where(in_collision, coll_valid, nc_valid)
    return point, direction, valid


def obstacle_orca_lines(pos, vel, rad, p1, p2, emask, time_horizon_obst):
    """ORCA lines of acting agents vs. ``E`` padded directed obstacle edges
    each, with RVO2's sequential already-covered pruning. Edges must come
    nearest first (RVO2's order, on which the pruning depends).

    Shapes: pos, vel (..., 2); rad (...); p1, p2 (..., E, 2); emask
    (..., E). Returns (points (..., E, 2), dirs (..., E, 2), valid (..., E)).
    """
    inv_th = 1.0 / time_horizon_obst
    pos_ = pos[..., None, :]
    pts, dirs, raw_valid = edge_orca_line(pos_, vel[..., None, :],
                                          rad[..., None], p1, p2, inv_th)
    # covered[..., i, j]: edge i lies behind the line of an earlier edge j
    rp1 = (inv_th * (p1 - pos_))[..., :, None, :]
    rp2 = (inv_th * (p2 - pos_))[..., :, None, :]
    lp = pts[..., None, :, :]
    ld = dirs[..., None, :, :]
    r_th = (inv_th * rad)[..., None, None]
    c12 = ((det2(rp1 - lp, ld) - r_th >= -RVO_EPSILON) &
           (det2(rp2 - lp, ld) - r_th >= -RVO_EPSILON))
    own = raw_valid & emask
    valid = torch.zeros_like(own)
    for i in range(p1.shape[-2]):
        covered = (valid & c12[..., i, :]).any(dim=-1)
        valid[..., i] = own[..., i] & ~covered
    return pts, dirs, valid


# ---------------------------------------------------------------------------
# Incremental 2D linear program (RVO2 linearProgram1/2/3)
# ---------------------------------------------------------------------------

def _lp1_all(points, dirs, valid, radius, opt_vel, direction_opt):
    """RVO2 linearProgram1 for every line at once.

    Line ``i`` is solved on its own boundary subject to the valid lines
    before it; the loop over prior constraints is a masked min/max.
    Shapes: points, dirs (..., L, 2); valid (..., L); radius (...);
    opt_vel (..., 2). Returns (new_result (..., L, 2), ok (..., L)).
    """
    L = points.shape[-2]
    opt = opt_vel[..., None, :]
    dot_prod = dot2(points, dirs)                                 # (..., L)
    disc = dot_prod * dot_prod + (radius * radius)[..., None] - \
        dot2(points, points)
    ok0 = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t_left0 = -dot_prod - sqrt_disc
    t_right0 = -dot_prod + sqrt_disc

    idx = torch.arange(L, device=points.device)
    prior = valid[..., None, :] & (idx[None, :] < idx[:, None])  # [.., i, j]

    pt_i = points[..., :, None, :]
    dr_i = dirs[..., :, None, :]
    dirs_j = dirs[..., None, :, :]
    denom = det2(dr_i, dirs_j)                                   # (..., L, L)
    numer = det2(dirs_j, pt_i - points[..., None, :, :])
    not_par = denom.abs() > RVO_EPSILON
    fail_parallel = prior & ~not_par & (numer < 0.0)

    tt = numer / torch.where(not_par, denom, torch.full_like(denom, math.inf))
    upper = torch.where(prior & not_par & (denom >= 0.0), tt,
                        torch.full_like(tt, _BIG))
    lower = torch.where(prior & not_par & (denom < 0.0), tt,
                        torch.full_like(tt, -_BIG))
    t_right = torch.minimum(t_right0, upper.amin(dim=-1))
    t_left = torch.maximum(t_left0, lower.amax(dim=-1))

    ok = ok0 & ~fail_parallel.any(dim=-1) & (t_left <= t_right)

    if direction_opt:
        t = torch.where(dot2(opt, dirs) > 0.0, t_right, t_left)
    else:
        t_opt = dot2(dirs, opt - points)
        t = torch.minimum(torch.maximum(t_opt, t_left), t_right)
    return points + t[..., None] * dirs, ok


def _lp2(points, dirs, valid, radius, opt_vel, direction_opt):
    """RVO2 linearProgram2 over a masked fixed-size line set.

    Returns (result (..., 2), fail (...)) with fail = -1 on success, else
    the slot of the first line whose LP1 was infeasible.
    """
    if direction_opt:
        result = opt_vel * radius[..., None]
    else:
        over = dot2(opt_vel, opt_vel) > radius * radius
        result = _where2(over, normalize(opt_vel) * radius[..., None], opt_vel)

    new_result, ok = _lp1_all(points, dirs, valid, radius, opt_vel,
                              direction_opt)
    fail = torch.full(valid.shape[:-1], -1, dtype=torch.int64,
                      device=points.device)
    for i in range(points.shape[-2]):
        violated = det2(dirs[..., i, :], points[..., i, :] - result) > 0.0
        do = valid[..., i] & (fail < 0) & violated
        result = _where2(do & ok[..., i], new_result[..., i, :], result)
        fail = torch.where(do & ~ok[..., i], i, fail)
    return result, fail


def _lp3(points, dirs, valid, is_obst, begin_line, radius, result):
    """RVO2 linearProgram3: minimize the largest violation of the agent
    lines at or after ``begin_line`` while keeping obstacle lines hard.

    Shapes: points, dirs (B, L, 2); valid, is_obst (B, L); begin_line,
    radius (B,); result (B, 2).
    """
    L = points.shape[-2]
    idx = torch.arange(L, device=points.device)

    # projected line set of every outer line i at once: [b, i, j]
    d_i = dirs[:, :, None, :]
    p_i = points[:, :, None, :]
    d_j = dirs[:, None, :, :]
    p_j = points[:, None, :, :]
    denom = det2(d_i, d_j)
    not_par = denom.abs() > RVO_EPSILON
    same_dir = dot2(d_i, d_j) > 0.0
    mid_pt = 0.5 * (p_i + p_j)
    inter_pt = p_i + (det2(d_j, p_i - p_j) / torch.where(
        not_par, denom, torch.full_like(denom, math.inf)))[..., None] * d_i
    proj_pt = _where2(~not_par, mid_pt, inter_pt)
    proj_dir = normalize(d_j - d_i)

    obst_j = is_obst[:, None, :]
    agent_prior = valid[:, None, :] & ~obst_j & (idx[None, :] < idx[:, None])
    keep = agent_prior & ~(~not_par & same_dir)
    pl_pts = _where2(obst_j, p_j, proj_pt)
    pl_dirs = _where2(obst_j, d_j, proj_dir)
    pl_valid = (valid & is_obst)[:, None, :] | keep

    opt = torch.stack([-dirs[..., 1], dirs[..., 0]], dim=-1)      # (B, L, 2)
    inner, inner_fail = _lp2(pl_pts, pl_dirs, pl_valid,
                             radius[:, None].expand(-1, L), opt, True)

    distance = torch.zeros_like(radius)
    for i in range(L):
        d_i, p_i = dirs[:, i], points[:, i]
        active = valid[:, i] & (i >= begin_line)
        do = active & (det2(d_i, p_i - result) > distance)
        # keep the previous result on inner failure (RVO2: "this should in
        # principle not happen")
        result = _where2(do & (inner_fail[:, i] < 0), inner[:, i], result)
        distance = torch.where(do, det2(d_i, p_i - result), distance)
    return result


def solve_orca_lp(points, dirs, valid, is_obst, radius, pref_vel,
                  host_read: bool = True):
    """Full RVO2 velocity selection: LP2 with the LP3 fallback.

    Shapes: points, dirs (B, L, 2) with obstacle slots first; valid, is_obst
    (B, L); radius (B,) max speed; pref_vel (B, 2). Returns (B, 2).

    LP3 runs only when some agent's LP2 failed. The reference computes it
    for every agent and selects; skipping it when no agent needs it costs
    one host read of the fail flags and saves a few hundred launches.
    ``host_read=False`` computes it always, as the reference does: under
    ``torch.func.vmap`` the read would raise.
    """
    result, fail = _lp2(points, dirs, valid, radius, pref_vel, False)
    needs3 = fail >= 0
    if host_read and not bool(needs3.any()):
        return result
    L = points.shape[-2]
    begin = torch.where(needs3, fail, L)
    result3 = _lp3(points, dirs, valid, is_obst, begin, radius, result)
    return _where2(needs3, result3, result)


# ---------------------------------------------------------------------------
# Full acting-agent ORCA step
# ---------------------------------------------------------------------------

def _gather(x, order):
    """x (B, N, ...) reordered along N by order (B, N)."""
    if x.dim() == order.dim():
        return torch.gather(x, 1, order)
    return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))


def _sort_neighbors(pos, npos, nmask, neighbor_dist, max_neighbors):
    """Order neighbour slots nearest first and mask out-of-range slots.
    Shapes: pos (B, 2); npos (B, N, 2); nmask (B, N)."""
    d = norm2(npos - pos[:, None, :])
    in_range = nmask & (d < neighbor_dist)
    key = torch.where(in_range, d, torch.full_like(d, _BIG))
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_in_range = torch.gather(in_range, 1, order)
    if max_neighbors is not None:
        rank = torch.arange(npos.shape[1], device=npos.device)
        sorted_in_range = sorted_in_range & (rank < max_neighbors)
    return order, sorted_in_range


def _sort_edges(pos, ep1, ep2, emask, range_):
    """Order directed obstacle edges by point-to-segment distance. An edge is
    visible only when the agent is strictly on its right side (RVO2's CCW
    convention). Shapes: pos (B, 2); ep1, ep2 (B, E, 2); emask (B, E);
    range_ (B,)."""
    pos_ = pos[:, None, :]
    cp = closest_point_on_segment(ep1, ep2, pos_)
    d = norm2(cp - pos_)
    right_of = det2(ep2 - ep1, pos_ - ep1) < 0.0
    in_range = emask & (d < range_[:, None]) & right_of
    key = torch.where(in_range, d, torch.full_like(d, _BIG))
    order = torch.argsort(key, dim=-1, stable=True)
    return order, torch.gather(in_range, 1, order)


def orca_velocity(pos, vel, rad, pref_vel, max_speed, npos, nvel, nrad, nmask,
                  ep1, ep2, emask, params: OrcaParams, max_neighbors: int = 10):
    """New velocities for a batch of acting agents: one RVO2 ``doStep`` of
    agent 0 each (reference ``orca_velocity`` under ``vmap``).

    Shapes: pos, vel, pref_vel (B, 2); rad, max_speed (B,); npos, nvel
    (B, N, 2); nrad, nmask (B, N); ep1, ep2 (B, E, 2); emask (B, E).
    Returns (B, 2).
    """
    obst_range = params.time_horizon_obst * max_speed + rad
    eorder, evalid = _sort_edges(pos, ep1, ep2, emask, obst_range)
    o_pts, o_dirs, o_valid = obstacle_orca_lines(
        pos, vel, rad, _gather(ep1, eorder), _gather(ep2, eorder), evalid,
        params.time_horizon_obst)

    norder, nvalid = _sort_neighbors(pos, npos, nmask, params.neighbor_dist,
                                     max_neighbors)
    a_pts, a_dirs, a_valid = agent_orca_lines(
        pos, vel, rad, _gather(npos, norder), _gather(nvel, norder),
        _gather(nrad, norder), nvalid, params.time_horizon, params.dt)

    points = torch.cat([o_pts, a_pts], dim=1)
    dirs = torch.cat([o_dirs, a_dirs], dim=1)
    valid = torch.cat([o_valid, a_valid], dim=1)
    is_obst = torch.cat([torch.ones_like(o_valid), torch.zeros_like(a_valid)],
                        dim=1)
    return solve_orca_lp(points, dirs, valid, is_obst, max_speed, pref_vel)


def walls_to_edges(walls, wmask):
    """(..., W, 2, 2) wall segments -> (..., 2W, 2) directed edges, both
    orientations. Returns (ep1, ep2, emask)."""
    w0, w1 = walls[..., 0, :], walls[..., 1, :]
    p1 = torch.cat([w0, w1], dim=-2)
    p2 = torch.cat([w1, w0], dim=-2)
    emask = torch.cat([wmask, wmask], dim=-1)
    return p1, p2, emask

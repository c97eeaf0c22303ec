"""Feasible warmstart generation for CAMPC (twin of
``sicnav_tpu/mpc/warmstart.py``).

The humans step forward with the batched ORCA LP (``ops.orca``) over the
MPC's internal model, with duals recovered from the active set by a masked
least-squares fit to stationarity and polished by damped Newton steps on
the embedded KKT system; the robot is an ORCA agent toward its goal. Where
the reference maps one human with ``vmap``, every function here solves all
humans of a stage at once.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacrev

from portbench.reference.frozen.mpc import orca_lines as OL
from portbench.reference.frozen.mpc.ocp import KKT_RHO, MPCParams, OCP, zero_slacks
from portbench.reference.frozen.ops.geometry import norm2
from portbench.reference.frozen.ops.orca import solve_orca_lp


def _lp_lines(norms, scalars):
    """Half-planes n.v >= b as the LP's (point, direction) lines: feasible
    = left of (point, dir) with dir = (n_y, -n_x)."""
    nn = torch.clamp(torch.sum(norms * norms, -1), min=1e-12)
    pts = scalars[..., None] * norms / nn[..., None]
    dirs = torch.stack([norms[..., 1], -norms[..., 0]], -1)
    return pts, dirs


def _block_diag(J):
    """(H, a, H, b) Jacobian of per-human functions -> (H, a, b) blocks.
    (The Jacobians are taken in reverse mode; see mpc/ipm.py.)"""
    return torch.diagonal(J, dim1=0, dim2=2).permute(2, 0, 1)


def solve_human_step(ocp: OCP, params: MPCParams, xr, xh,
                     newton_iters: int = 8):
    """Every human's relaxed-ORCA solve at one stage, with KKT-consistent
    duals: the ORCA LP gives the primal point, active-set least squares an
    initial dual estimate, then damped square-Newton iterations on the
    embedded KKT system F(w, lam) = [grad_w L; lam * g - rho] drive the
    residuals the upper level penalizes to ~0.

    Returns (u (H, 3) [vx, vy, ksi_raw], lam (H, n_lam))."""
    cfg = ocp.cfg
    sv, sk = cfg.orca_vxy_scaling, cfg.orca_ksi_scaling
    # the lines depend on the stage only: computed once for the LP, the
    # dual fit and every Newton step
    lines = ocp.human_lines(params, xr, xh)
    norms, scalars, _ = lines
    H, L = scalars.shape
    v_max = params.v_max_prefs
    v_pref = OL.v_pref_from_state(xh[:, :2], xh[:, 4:6], v_max)

    pts, dirs = _lp_lines(norms, scalars)
    valid = torch.ones((H, L), dtype=torch.bool, device=pts.device)
    v = solve_orca_lp(pts, dirs, valid, ~valid, v_max, v_pref,
                      host_read=not ocp.vmapped)

    g_lines = scalars - torch.sum(norms * v[:, None, :], -1)   # >0 violated
    ksi_raw0 = torch.clamp(torch.amax(g_lines, dim=-1), min=0.0) / sk
    w0 = torch.cat([v / sv, ksi_raw0[:, None]], -1)

    # initial duals: least squares on stationarity over the active set
    def g_fn(w):
        return ocp.human_orca_g(params, xr, xh, w, lines)

    g0 = g_fn(w0)
    n_lam = g0.shape[-1]
    act = g0 > -1e-5
    grad_g = _block_diag(jacrev(g_fn)(w0))                       # (H, n_lam, 3)
    grad_f = grad(lambda w: OL.lower_level_cost(
        sv * w[:, :2], sk * w[:, 2], v_pref).sum())(w0)          # (H, 3)
    A = torch.where(act[..., None], grad_g, 0.0)
    eye = torch.eye(n_lam, dtype=A.dtype, device=A.device)
    AtA = A @ A.transpose(-1, -2) + 1e-8 * eye
    lam0 = torch.clamp(torch.linalg.solve_ex(
        AtA, A @ (-grad_f)[..., None])[0][..., 0], 0.0, 1e4)

    # damped Newton on F(w, lam) = [grad_w L; lam * g - rho]
    def kkt_res(wl):
        g, grad_w = ocp.human_kkt_rows(params, xr, xh, wl[:, :3], wl[:, 3:],
                                       lines)
        return torch.cat([grad_w, wl[:, 3:] * g - KKT_RHO], -1)

    wl = torch.cat([w0, lam0], -1)
    eye_w = torch.eye(wl.shape[-1], dtype=wl.dtype, device=wl.device)
    for _ in range(newton_iters):
        res = kkt_res(wl)
        J = _block_diag(jacrev(kkt_res)(wl)) + 1e-8 * eye_w
        dwl = torch.linalg.solve_ex(J, -res[..., None])[0][..., 0]
        # damped update keeping the duals nonnegative
        wl_new = wl + torch.clamp(dwl, -1.0, 1.0)
        wl_new = torch.cat([wl_new[:, :3], torch.clamp(wl_new[:, 3:], min=0.0)],
                           -1)
        better = torch.sum(kkt_res(wl_new) ** 2, -1) < torch.sum(res ** 2, -1)
        wl = torch.where(better[:, None], wl_new, wl)
    return wl[:, :3], wl[:, 3:]


def robot_warmstart_velocity(ocp: OCP, params: MPCParams, xr, xh):
    """The robot as an ORCA agent toward its goal: ORCA LP over its pairwise
    lines vs every human and its wall lines."""
    cfg = ocp.cfg
    op = cfg.orca_params
    pos = xr[:2]
    vel = ocp.rob_vel(xr)
    rad = params.rob_radius
    n_p, s_p = OL.pairwise_line(pos, vel, xh[:, :2], xh[:, 2:4], rad,
                                params.hum_radii, op)
    n_s, s_s = OL.static_line(pos, vel, rad, params.walls, params.wall_mask,
                              op)
    norms = torch.cat([n_p, n_s], 0)
    scalars = torch.cat([s_p, s_s], 0)

    goal_vec = params.goal - pos
    mag = norm2(goal_vec)
    v_pref = torch.where(
        mag > cfg.pref_speed,
        goal_vec / torch.clamp(mag, min=1e-9) * cfg.pref_speed, goal_vec)

    if cfg.robot_nx == 8 and cfg.momentum_warmstart:
        # the RA-L warmstart pref-vel: the goal pull in the heading frame,
        # flipped to (0.01 x_vf, -y_vf) when behind or > 80 deg off-heading,
        # then blended 95% with the current speed rotated by the current rate
        s, c = xr[2], xr[3]
        vf_x = c * v_pref[0] + s * v_pref[1]
        vf_y = -s * v_pref[0] + c * v_pref[1]
        in_front = ((vf_x > 0.0) &
                    (torch.abs(torch.atan2(vf_y, vf_x)) < 80.0 * torch.pi / 180.0))
        fx, fy = 0.01 * vf_x, -vf_y
        flip_i = torch.stack([c * fx - s * fy, s * fx + c * fy])
        v0 = torch.where(in_front, v_pref, flip_i)
        om_cur, dt = xr[5], cfg.dt
        s_n = s * torch.cos(om_cur * dt) + c * torch.sin(om_cur * dt)
        c_n = c * torch.cos(om_cur * dt) - s * torch.sin(om_cur * dt)
        v_pref = 0.05 * v0 + 0.95 * (xr[4] * torch.stack([c_n, s_n]))

    pts, dirs = _lp_lines(norms, scalars)
    valid = torch.ones(pts.shape[:1], dtype=torch.bool, device=pts.device)
    return solve_orca_lp(pts[None], dirs[None], valid[None], ~valid[None],
                         torch.full((1,), cfg.max_speed, dtype=pts.dtype,
                                    device=pts.device), v_pref[None],
                         host_read=not ocp.vmapped)[0]


def _vel_to_unicycle(ocp: OCP, xr, v_des):
    """A desired holonomic velocity -> feasible (v, om): rotate toward the
    desired heading within max_rot, speed within the accel limits."""
    cfg = ocp.cfg
    s, c = ocp.rob_heading(xr)
    th = torch.atan2(s, c)
    des_th = torch.atan2(v_des[1], v_des[0])
    dth = torch.atan2(torch.sin(des_th - th), torch.cos(des_th - th))
    om = torch.clamp(dth / cfg.dt, -cfg.max_rot + 0.001, cfg.max_rot)
    sp = norm2(v_des) * torch.cos(torch.clamp(dth, -torch.pi / 2,
                                              torch.pi / 2))
    sp = torch.clamp(sp, min=0.0)
    v_prev = ocp.rob_v_prev(xr)
    sp = torch.minimum(torch.maximum(sp, torch.clamp(
        v_prev + cfg.max_l_dcc * cfg.dt, min=0.0)), torch.clamp(
        v_prev + cfg.max_l_acc * cfg.dt, max=cfg.max_speed))
    return torch.stack([sp, om])


def _human_next(ocp: OCP, xh, uh):
    vel = ocp.cfg.orca_vxy_scaling * uh[:, :2]
    return torch.cat([xh[:, :2] + vel * ocp.cfg.dt, vel, xh[:, 4:6]], -1)


def plan_human_rollout(ocp: OCP, params: MPCParams, u_rob):
    """Roll the horizon with the given robot controls and the humans
    responding through exact per-stage lower-level ORCA solves.

    Returns (X_rob (K+1, nx), X_hums (K+1, H, 6), u_hums (K, H, 3),
    lam (K, H, n_lam))."""
    xr, xh = params.x0_rob, params.hums0
    xs_r, xs_h, uhs, lams = [xr], [xh], [], []
    for k in range(ocp.cfg.K):
        uh, lam = solve_human_step(ocp, params, xr, xh)
        xr = ocp.robot_step(xr, u_rob[k])
        xh = _human_next(ocp, xh, uh)
        xs_r.append(xr)
        xs_h.append(xh)
        uhs.append(uh)
        lams.append(lam)
    return (torch.stack(xs_r), torch.stack(xs_h), torch.stack(uhs),
            torch.stack(lams))


def exact_human_rollout(ocp: OCP, params: MPCParams, u_rob):
    """(X_rob, X_hums) of plan_human_rollout."""
    X_rob, X_hums, _, _ = plan_human_rollout(ocp, params, u_rob)
    return X_rob, X_hums


def z_from_robot_plan(ocp: OCP, params: MPCParams, u_rob):
    """Pack a robot control plan (K, 2) into a KKT-consistent decision
    vector: humans respond through exact lower-level solves, the slacks are
    inferred from the residuals."""
    _, _, u_hums, lam = plan_human_rollout(ocp, params, u_rob)
    Ko = ocp.cfg.K_orca
    z = ocp.pack(u_rob, u_hums[:Ko], lam[:Ko],
                 zero_slacks(ocp.cfg.num_hums, u_rob.device))
    return ocp.infer_slacks(z, params)


def warmstart_horizon(ocp: OCP, params: MPCParams):
    """Full-horizon feasible warmstart: roll the robot (ORCA as an agent)
    and the humans (per-human ORCA solves with duals) forward. Returns the
    packed decision vector z0 (slacks zero)."""
    xr, xh = params.x0_rob, params.hums0
    u_robs, uhs, lams = [], [], []
    for _ in range(ocp.cfg.K):
        v_rob = robot_warmstart_velocity(ocp, params, xr, xh)
        u_rob = _vel_to_unicycle(ocp, xr, v_rob)
        uh, lam = solve_human_step(ocp, params, xr, xh)
        xr = ocp.robot_step(xr, u_rob)
        xh = _human_next(ocp, xh, uh)
        u_robs.append(u_rob)
        uhs.append(uh)
        lams.append(lam)
    Ko = ocp.cfg.K_orca
    return ocp.pack(torch.stack(u_robs), torch.stack(uhs)[:Ko],
                    torch.stack(lams)[:Ko],
                    zero_slacks(ocp.cfg.num_hums, params.x0_rob.device))

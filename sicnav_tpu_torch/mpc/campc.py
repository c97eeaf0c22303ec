"""CollisionAvoidMPC (CAMPC), the SICNav robot policy (twin of
``sicnav_tpu/mpc/campc.py``).

Per control step: build the point-stabilization reference (with hallway
intermediate goals and the door-yield pocket), select the initial guess
(the shifted previous solution or a fresh feasible warmstart), solve the
ORCA-KKT NLP with the interior-point solver, and run the failure cascade
(solution -> guess -> emergency brake), auditing plans against the exact
lower-level human responses.

The reference runs a step as one jitted program and takes its ``lax.cond``
branches on the device. Here the two branches that only save work (the
guess's exact-rollout margin, needed only when the guess is adopted, and
the evasive-brake fan) read their condition on the host, once per step;
the values are the reference's. On an OCP built ``vmapped`` (a controller
under ``torch.func.vmap`` over episodes) both branches are computed and
selected, as ``lax.cond`` does under ``jax.vmap``. The multi-start solves
run one after another where the reference ``vmap``s them. The
adaptive-effort budget is read on the host once per step; on a ``vmapped``
OCP it stays a tensor per episode, and the solver freezes an episode's
iterate once its budget is spent.

With ``utils.tracing`` on, a step records an ``mpc`` span holding
``mpc.problem``, ``mpc.guess``, ``mpc.solve`` and ``mpc.cascade``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from sicnav_tpu_torch.env.crowd_sim import intermediate_goals, stack
from sicnav_tpu_torch.env.types import EnvConfig, SimState
from sicnav_tpu_torch.mpc import introspection as IN
from sicnav_tpu_torch.mpc import ipm, warmstart as WS
from sicnav_tpu_torch.mpc.ocp import MPCConfig, MPCParams, OCP
from sicnav_tpu_torch.mpc.ref_traj import point_stab_reference
from sicnav_tpu_torch.ops.geometry import (linspace, norm2,
                                           point_to_segment_dist,
                                           seg_seg_dist, wrap_angle)
from sicnav_tpu_torch.utils import tracing


class CAMPCCarry(NamedTuple):
    """Cross-step policy state. ``pred_rob`` / ``pred_hums`` hold the
    adopted plan's stage-1 robot pose (x, y, theta) and human positions, the
    anchor of the next step's discrepancy test."""
    z_prev: torch.Tensor
    has_prev: torch.Tensor       # bool
    prev_ok: torch.Tensor        # bool: the previous solve succeeded; after
                                 # a failure the fresh warmstart is rebuilt
    num_prev_used: torch.Tensor  # int32
    pred_rob: torch.Tensor       # (3,)
    pred_hums: torch.Tensor      # (H, 2)
    door_stall: torch.Tensor     # int32: consecutive stalled-near-door steps
    door_latch: torch.Tensor     # bool: yield mode latched


class CAMPCAux(NamedTuple):
    """Per-step solve telemetry: which cascade branch produced the executed
    action and how safe the adopted plan looked under the exact lower-level
    human model."""
    use_guess: torch.Tensor      # bool: the cascade rejected the solution
    sol_feasible: torch.Tensor
    sol_realistic: torch.Tensor  # exact-rollout reality check passed
    cost_worse: torch.Tensor     # the solution costs more than the guess
    braked: torch.Tensor         # emergency brake taken
    rescued: torch.Tensor        # best-exact-margin start executed
    slack_max: torch.Tensor      # max slack of the adopted plan
    exact_margin: torch.Tensor   # min_k,h (d_exact - comb) of the adopted plan
    ineq_viol: torch.Tensor
    eq_viol: torch.Tensor


def init_carry(ocp: OCP) -> CAMPCCarry:
    dev = ocp.device

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    false = zeros((), torch.bool)
    return CAMPCCarry(z_prev=zeros((ocp.cfg.n_z,)), has_prev=false,
                      prev_ok=false, num_prev_used=zeros((), torch.int32),
                      pred_rob=zeros((3,)),
                      pred_hums=zeros((ocp.cfg.num_hums, 2)),
                      door_stall=zeros((), torch.int32), door_latch=false)


# door-yield behaviour thresholds; the geometry is derived per layout
_YIELD_TRANSIT_D = 0.30   # goal-estimate displacement that marks "moving"
_YIELD_STALL_V = 0.05     # executed speed below this counts as stalled


def _yield_geometry(state: SimState, cfg: MPCConfig, r_dir, side):
    """The door-yield waiting pocket (2,): among an outward grid of
    candidates at the setback line, the innermost whose approach segment
    clears every active wall by the MPC's own wall-row radius; else back
    straight off in-lane at 1.5x the setback."""
    door = state.door
    center = torch.stack([door.x_mid, 0.5 * (door.y_min + door.y_max)])
    pocket_back = 0.9 * door.width
    # the MPC's wall-row radius (as in OCP._groups_from)
    rob_r = state.r_radius
    reach = cfg.max_speed * cfg.dt
    stat_buf = torch.where(reach >= rob_r, reach - rob_r + 0.01,
                           torch.full_like(rob_r, 0.05))
    comb = rob_r + stat_buf + cfg.wall_margin

    y_p = center[1] - r_dir * pocket_back
    want = 0.5 * door.width + 0.08
    cand_x = door.x_mid + side * (want + linspace(0.0, 0.6, 8,
                                                  device=y_p.device))
    cand = torch.stack([cand_x, y_p.expand(cand_x.shape)], -1)     # (8, 2)
    anchor = torch.stack([door.x_mid, y_p])
    W = state.walls.shape[0]
    d = seg_seg_dist(anchor.expand(8, W, 2), cand[:, None, :].expand(8, W, 2),
                     state.walls[None, :, 0], state.walls[None, :, 1])
    d_walls = torch.amin(torch.where(state.wall_mask[None], d, torch.inf),
                         dim=-1)                                   # (8,)
    clears = d_walls >= comb
    any_clear = clears.any()
    first = torch.argmax(clears.to(torch.int32))
    side_pocket = cand[torch.where(any_clear, first, torch.argmax(d_walls))]
    back_pocket = torch.stack([door.x_mid,
                               center[1] - r_dir * 1.5 * pocket_back])
    return torch.where(any_clear, side_pocket, back_pocket)


def _yield_scalars(state: SimState):
    """(center, r_occ, pass_band, near_d) of the door-yield geometry."""
    door = state.door
    center = torch.stack([door.x_mid, 0.5 * (door.y_min + door.y_max)])
    r_occ = 0.5 * door.width + 0.05
    pass_band = state.r_radius + 0.10
    near_d = r_occ + 0.65
    return center, r_occ, pass_band, near_d


def door_yield_update(state: SimState, h_goal_est, cfg: MPCConfig,
                      door_stall, door_latch):
    """Direction-filtered latched door yielding (cfg.door_yield): an
    oncoming, transiting human deeper into the door mouth than the robot
    sends the robot's reference goal to a waiting pocket, latched until the
    mouth clears or cfg.door_yield_hold_max steps pass, then a cooldown of
    cfg.door_yield_cooldown steps with the trigger off. ``door_stall``
    counts stalled steps (unlatched, >= 0), the cooldown (unlatched, < 0)
    or the hold (latched). Returns (use_pocket, pocket, stall', latch')."""
    door = state.door
    center, r_occ, pass_band, near_d = _yield_scalars(state)
    r_dir = torch.where(state.r_goal[1] >= state.r_pos[1], 1.0, -1.0)
    ys_min = torch.minimum(state.r_pos[1], state.r_goal[1])
    ys_max = torch.maximum(state.r_pos[1], state.r_goal[1])
    crosses = (ys_min < door.y_mid_min) & (ys_max > door.y_mid_max)
    not_through = (state.r_pos[1] - center[1]) * r_dir < pass_band
    engaged = door.has_door & crosses & not_through
    robot_d = norm2(state.r_pos - center)

    H = cfg.num_hums
    h_pos = state.h_pos[:H]
    h_d = torch.linalg.norm(h_pos - center[None], dim=-1)
    disp = h_goal_est[:H] - h_pos
    # oncoming = intent opposes the robot's crossing direction
    oncoming = disp[:, 1] * r_dir < 0.0
    transiting = (state.h_mask[:H] & (h_d < r_occ) & oncoming &
                  (torch.linalg.norm(disp, dim=-1) > _YIELD_TRANSIT_D))
    deeper = transiting & (h_d < robot_d)

    stalled_now = (engaged & (robot_d < near_d) &
                   (norm2(state.r_vel) < _YIELD_STALL_V))
    one, zero = torch.ones_like(door_stall), torch.zeros_like(door_stall)
    cnt_unl = torch.where(door_stall < 0, door_stall + one,
                          torch.where(stalled_now, door_stall + one, zero))
    trigger = (engaged & (cnt_unl >= 0) & (cnt_unl >= cfg.door_yield_stall)
               & deeper.any())
    cnt_lat = door_stall + one
    timed_out = cnt_lat >= cfg.door_yield_hold_max
    stay = engaged & transiting.any() & ~timed_out
    latch_new = torch.where(door_latch, stay, trigger)
    stall_new = torch.where(
        door_latch,
        torch.where(stay, cnt_lat,
                    torch.where(timed_out,
                                torch.full_like(door_stall,
                                                -cfg.door_yield_cooldown),
                                zero)),
        torch.where(trigger, zero, cnt_unl))

    # pocket on the side away from the blocking traffic's lateral mean
    blockers = torch.where(deeper.any(), deeper, transiting)
    wx = torch.sum(torch.where(blockers, h_pos[:, 0] - door.x_mid, 0.0))
    side = torch.where(wx >= 0.0, -1.0, 1.0)
    pocket = _yield_geometry(state, cfg, r_dir, side)
    return latch_new, pocket, stall_new, latch_new


def build_params(ocp: OCP, state: SimState, env_cfg: EnvConfig,
                 mid_samples=None, mid_logw0=None, goal_override=None,
                 cost_weights=None) -> MPCParams:
    """SimState -> MPCParams in the privileged or unprivileged model view
    (unprivileged: human goals are a 2 s constant-velocity projection and
    v_pref the configured bound). ``mid_samples`` (S, H, K+2, 2) and
    ``mid_logw0`` (S,) supply the forecast grid; ``goal_override`` is
    (use_pocket, pocket) from the door-yield protocol."""
    cfg = ocp.cfg
    H = cfg.num_hums
    dev = state.r_pos.device

    v = state.r_vel
    heading = torch.atan2(v[1], v[0])
    # wrapped angular distance: a plain modulo misses the -eps side and
    # flags forward motion as reverse at float precision
    aligned = torch.abs(wrap_angle(state.r_theta - heading)) < 1e-3
    speed = norm2(v)
    v_signed = torch.where(speed < 1e-9, torch.zeros_like(speed),
                           torch.where(aligned, speed, -speed))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.robot_nx == 8:
        x0_rob = torch.stack([
            state.r_pos[0], state.r_pos[1], torch.sin(state.r_theta),
            torch.cos(state.r_theta), v_signed, state.r_omega, zero, zero])
    else:
        x0_rob = torch.stack([state.r_pos[0], state.r_pos[1], state.r_theta,
                              v_signed])

    if cfg.priviledged_info:
        goals = state.h_goal[:H]
        v_max = state.h_v_pref[:H]
    else:
        goals = state.h_pos[:H] + state.h_vel[:H] * 2.0
        v_max = torch.full((H,), cfg.human_max_speed, device=dev)
    hums0 = torch.cat([state.h_pos[:H], state.h_vel[:H], goals], dim=-1)

    # robot intermediate goal through hallway doors
    goal = intermediate_goals(state.r_pos[None], state.r_goal[None],
                              state.door)[0]
    if goal_override is not None:
        use_pocket, pocket = goal_override
        goal = torch.where(use_pocket, pocket, goal)

    if cfg.ref_type == "point_stab":
        poses, ref_act = point_stab_reference(
            state.r_pos, state.r_theta, goal, cfg.K, cfg.dt, cfg.pref_speed,
            cfg.max_rot, state.r_radius)
        if cfg.robot_nx == 8:
            # v_ref at stage k is the action that reaches pose k
            v_ref = torch.cat([ref_act[0:1, 0], ref_act[:, 0]])[:, None]
            x_ref = torch.cat([poses[:, :2], torch.sin(poses[:, 2:3]),
                               torch.cos(poses[:, 2:3]), v_ref], dim=-1)
        else:
            x_ref = poses[:, :2]
    elif cfg.robot_nx == 8:
        to_goal = goal - state.r_pos
        ref_th = torch.atan2(to_goal[1], to_goal[0])
        v_ref = torch.where(norm2(to_goal) > state.r_radius,
                            torch.full_like(ref_th, cfg.pref_speed),
                            torch.zeros_like(ref_th))
        x_ref = torch.cat([goal, torch.sin(ref_th)[None],
                           torch.cos(ref_th)[None], v_ref[None]]
                          )[None].repeat(cfg.K + 1, 1)
    else:
        x_ref = goal[None].repeat(cfg.K + 1, 1)
    inflation = 0.01 + cfg.orca_params.safety_space
    n_s = max(cfg.num_mid_samples, 1)
    if mid_samples is None:
        # constant-velocity continuation of the current state
        steps = torch.arange(cfg.K + 2, device=dev)[None, :, None] * cfg.dt
        cv = state.h_pos[:H][:, None, :] + state.h_vel[:H][:, None, :] * steps
        mid_samples = cv[None].expand(n_s, H, cfg.K + 2, 2)
    if mid_logw0 is None:
        mid_logw0 = torch.full((n_s,), -float(torch.log(torch.tensor(
            float(n_s)))), device=dev)
    return MPCParams(
        x0_rob=x0_rob, goal=goal, hums0=hums0,
        hum_radii=state.h_radius[:H] + inflation,
        hum_coll_radii=state.h_radius[:H], v_max_prefs=v_max,
        rob_radius=state.r_radius,
        walls=state.walls[:cfg.num_walls],
        wall_mask=state.wall_mask[:cfg.num_walls],
        x_ref=x_ref, mid_samples=mid_samples, mid_logw0=mid_logw0,
        cost_w=(ocp.default_weights if cost_weights is None
                else cost_weights))


def _shift_guess(ocp: OCP, z_prev, params: MPCParams):
    """Shift the previous solution one stage and fill the last ORCA-KKT
    stage with a one-step warmstart from the rolled-out state."""
    k_last = ocp.cfg.K_orca - 1
    u_rob, u_hums, lam, slacks = ocp.unpack(z_prev)
    u_rob = torch.cat([u_rob[1:], u_rob[-1:]], 0)
    u_hums = torch.cat([u_hums[1:], u_hums[-1:]], 0)
    lam = torch.cat([lam[1:], lam[-1:]], 0)
    X_rob, X_hums = ocp.rollout(params, u_rob, u_hums)
    uh, lm = WS.solve_human_step(ocp, params, X_rob[k_last], X_hums[k_last])
    u_hums = torch.cat([u_hums[:k_last], uh[None]], 0)
    lam = torch.cat([lam[:k_last], lm[None]], 0)
    return ocp.pack(u_rob, u_hums, lam, slacks)


def reuse_limit(cfg: MPCConfig):
    """The previous-solution budget: unlimited with warmstart and the
    embedded-KKT model, else the ORCA-KKT horizon (KKT) or the full horizon
    (CVMM). None for unlimited."""
    if cfg.hum_model == "orca_casadi_kkt":
        return None if cfg.warmstart else max(cfg.K_orca, 0)
    return cfg.K


def _rob_pose(ocp: OCP, xr):
    sin_t, cos_t = ocp.rob_heading(xr)
    return torch.stack([xr[0], xr[1], torch.atan2(sin_t, cos_t)])


def _select_guess(ocp: OCP, carry: CAMPCCarry, params: MPCParams):
    """The shifted previous solution while the failure counter is under the
    reuse budget, the previous solve succeeded and the world evolved as it
    predicted (robot pose within 1e-2, humans within rob_rad_buffer); else a
    fresh feasible warmstart."""
    z_fresh = ocp.infer_slacks(WS.warmstart_horizon(ocp, params), params)
    return _select_from_fresh(ocp, carry, params, z_fresh)


def _select_from_fresh(ocp: OCP, carry: CAMPCCarry, params: MPCParams,
                       z_fresh):
    cfg = ocp.cfg
    limit = reuse_limit(cfg)
    counter_ok = (torch.ones_like(carry.has_prev) if limit is None
                  else carry.num_prev_used < limit)

    cur_rob = _rob_pose(ocp, params.x0_rob)
    d_rob = torch.abs(cur_rob - carry.pred_rob)
    d_rob = torch.cat([d_rob[:2], torch.abs(wrap_angle(
        cur_rob[2] - carry.pred_rob[2])).reshape(1)])
    d_hum = torch.linalg.norm(params.hums0[:, :2] - carry.pred_hums, dim=-1)
    consistent = (d_rob <= 1e-2).all() & (d_hum <= cfg.rob_rad_buffer).all()

    use_prev = carry.has_prev & carry.prev_ok & counter_ok & consistent
    z_shift = _shift_guess(ocp, torch.where(use_prev, carry.z_prev, z_fresh),
                           params)
    z_shift = ocp.infer_slacks(z_shift, params)
    z_guess = torch.where(use_prev, z_shift, z_fresh)
    return torch.where(torch.isfinite(z_guess).all(), z_guess, z_fresh)


def _brake_profile(ocp: OCP, params: MPCParams):
    """Robot brake plan (K, 2): decelerate at max_l_dcc to a stop, no turn."""
    cfg = ocp.cfg
    v0 = ocp.rob_v_prev(params.x0_rob)
    ks = torch.arange(1, cfg.K + 1, dtype=torch.float32, device=v0.device)
    v = torch.clamp(v0 + cfg.max_l_dcc * cfg.dt * ks, min=0.0)
    return torch.stack([v, torch.zeros_like(v)], -1)


def _min_wall_clearance(params: MPCParams, Xr):
    """Min robot-circle clearance to the active walls over a rollout's
    robot states (inf when no walls)."""
    d = point_to_segment_dist(params.walls[:, None, 0],
                              params.walls[:, None, 1], Xr[None, :, :2])
    d_w = torch.where(params.wall_mask, torch.amin(d, dim=-1), torch.inf)
    return torch.amin(d_w) - params.rob_radius


def _evasive_brake_action(ocp: OCP, params: MPCParams):
    """Max-margin emergency brake: the first action of the constant-turn
    decel plan (straight, half/full rate left and right) with the largest
    worst-case clearance to the exact human rollout and the walls."""
    cfg = ocp.cfg
    v0 = ocp.rob_v_prev(params.x0_rob)
    ks = torch.arange(1, cfg.K + 1, dtype=torch.float32, device=v0.device)
    v = torch.clamp(v0 + cfg.max_l_dcc * cfg.dt * ks, min=0.0)
    omegas = ocp.brake_omegas
    comb = params.hum_coll_radii + params.rob_radius
    margins = []
    for om in omegas:
        Xr, Xh = WS.exact_human_rollout(
            ocp, params, torch.stack([v, om.expand(v.shape)], -1))
        d_h = torch.linalg.norm(Xr[:, None, :2] - Xh[:, :, :2], dim=-1)
        margins.append(torch.minimum(torch.amin(d_h - comb[None, :]),
                                     _min_wall_clearance(params, Xr)))
    om_best = omegas[torch.argmax(torch.stack(margins))]
    return torch.stack([v[0], om_best])


def _dodge_goal(params: MPCParams):
    """Pull target of the side-step start: ~1.5 m ahead on the goal line,
    0.8 m to the side away from the crowd's lateral mean."""
    pos = params.x0_rob[:2]
    to_goal = params.goal - pos
    d = norm2(to_goal)
    dirv = to_goal / torch.clamp(d, min=1e-6)
    perp = torch.stack([-dirv[1], dirv[0]])
    lat = torch.sum((params.hums0[:, :2] - pos[None]) * perp[None], -1)
    side = torch.where(torch.sum(lat) >= 0.0, -1.0, 1.0)
    return pos + dirv * torch.clamp(d, max=1.5) + perp * (side * 0.8)


def _build_starts(ocp: OCP, carry: CAMPCCarry, params: MPCParams):
    """The cfg.multi_start initial guesses (M, n_z) and the selected guess.
    Order: [selected (shift-or-fresh), fresh warmstart, brake profile,
    lateral side-step], each KKT-consistent."""
    cfg = ocp.cfg
    z_fresh = ocp.infer_slacks(WS.warmstart_horizon(ocp, params), params)
    z_sel = _select_from_fresh(ocp, carry, params, z_fresh)
    zs = [z_sel, z_fresh]
    if cfg.multi_start > 2:
        zs.append(WS.z_from_robot_plan(ocp, params,
                                       _brake_profile(ocp, params)))
    if cfg.multi_start > 3:
        zs.append(ocp.infer_slacks(WS.warmstart_horizon(
            ocp, params._replace(goal=_dodge_goal(params))), params))
    return z_sel, torch.stack(zs[:cfg.multi_start])


def exact_plan_margin(ocp: OCP, params: MPCParams, u_rob, horizon: int = 0):
    """Min human-collision margin of a robot plan replayed against the
    exact lower-level human responses; horizon > 0 checks only the first
    ``horizon`` stages."""
    Xr, Xh = WS.exact_human_rollout(ocp, params, u_rob)
    d = torch.linalg.norm(Xr[:, None, :2] - Xh[:, :, :2], dim=-1)
    m = d - (params.hum_coll_radii[None, :] + params.rob_radius)
    if horizon > 0:
        m = m[:horizon + 1]
    return torch.amin(m)


def step_problem(ocp: OCP, state: SimState, carry: CAMPCCarry,
                 env_cfg: EnvConfig, mid_samples=None, mid_logw0=None,
                 h_intent=None, cost_weights=None):
    """The NLP of one control step: the door-yield update, the problem data
    and the functions the solver takes. Returns (params, (door_stall',
    door_latch'), (f, (c_E, c_I)) as functions of z)."""
    cfg = ocp.cfg
    if cfg.door_yield:
        # the intent estimate of the transit-vs-parked test (the fused
        # controller passes the observed h_goal)
        if h_intent is None:
            h_intent = (state.h_goal if cfg.priviledged_info
                        else state.h_pos + state.h_vel * 2.0)
        use_pocket, pocket, door_stall, door_latch = door_yield_update(
            state, h_intent, cfg, carry.door_stall, carry.door_latch)
        goal_override = (use_pocket, pocket)
    else:
        door_stall, door_latch = carry.door_stall, carry.door_latch
        goal_override = None
    params = build_params(ocp, state, env_cfg, mid_samples, mid_logw0,
                          goal_override=goal_override,
                          cost_weights=cost_weights)

    def f_fn(z):
        return ocp.cost(z, params)

    def c_fn(z):
        return ocp.residuals(z, params)

    return params, (door_stall, door_latch), (f_fn, c_fn)


@tracing.spanned("mpc")
def campc_action(ocp: OCP, state: SimState, carry: CAMPCCarry,
                 env_cfg: EnvConfig,
                 settings: ipm.IPMSettings = ipm.IPMSettings(),
                 mid_samples=None, mid_logw0=None, aux: bool = False,
                 h_intent=None, cost_weights=None, debug: bool = False):
    """One CAMPC control step. Returns (action (2,) = (v, r = om * dt),
    carry'); with ``aux=True`` also a ``CAMPCAux``; else with
    ``debug=True`` also an ``introspection.SolveDebug`` (the iteration
    trace and the named violations of the solution and the adopted plan).

    As in the reference, the debug path solves from the selected guess
    alone and never escalates (``adaptive_effort`` is ignored): to trace
    an escalated step, pass settings with the escalated ``n_iter``."""
    cfg = ocp.cfg
    with tracing.span("mpc.problem"):
        params, (door_stall, door_latch), (f_fn, c_fn) = \
            step_problem(ocp, state, carry, env_cfg, mid_samples, mid_logw0,
                         h_intent, cost_weights)
    comb = params.hum_coll_radii + params.rob_radius + cfg.rob_rad_buffer

    def plan_margin(u_rob_plan):
        # replay a robot plan against the exact lower-level human responses
        Xr_ex, Xh_ex = WS.exact_human_rollout(ocp, params, u_rob_plan)
        d_ex = torch.linalg.norm(Xr_ex[:, None, :2] - Xh_ex[:, :, :2], dim=-1)
        m = torch.amin(d_ex - comb[None, :])
        if cfg.wall_aware_realism:
            m = torch.minimum(m, _min_wall_clearance(params, Xr_ex))
        return m

    # failure-triggered effort escalation: a step whose previous solve the
    # cascade rejected gets cfg.adaptive_effort more IPM iterations; read
    # once per step on the host, or a tensor per episode when vmapped
    single = debug or cfg.multi_start <= 1
    with tracing.span("mpc.guess"):
        n_dyn, bound = None, None
        if cfg.adaptive_effort > 0 and not debug:
            escalate = carry.has_prev & ~carry.prev_ok
            bound = settings.n_iter + cfg.adaptive_effort
            if ocp.vmapped:
                n_dyn = settings.n_iter + \
                    cfg.adaptive_effort * escalate.to(torch.int32)
            else:
                n_dyn = bound if bool(escalate) else settings.n_iter
        if single:
            z_guess = _select_guess(ocp, carry, params)
        else:
            z_guess, starts = _build_starts(ocp, carry, params)

    def run(z0):
        return ipm.solve(f_fn, c_fn, z0, settings, n_iter_dyn=n_dyn,
                         n_iter_bound=bound)

    with tracing.span("mpc.solve"):
        if debug:
            z_sol, info, raw_trace = ipm.solve(f_fn, c_fn, z_guess, settings,
                                               return_trace=True)
        elif single:
            z_sol, info = run(z_guess)
        else:
            sols = [run(z0) for z0 in starts]

    with tracing.span("mpc.cascade"):
        if single:
            sol_margin = plan_margin(ocp.unpack(z_sol)[0])
        else:
            # the best exact-rollout-feasible solution by cost, the
            # goal-directed starts [selected, fresh] first
            z_sols = torch.stack([s[0] for s in sols])
            infos = ipm.IPMInfo(*[torch.stack(x) for x in
                                  zip(*[s[1] for s in sols])])
            costs = torch.stack([f_fn(z) for z in z_sols])
            finite = torch.isfinite(z_sols).all(dim=-1)
            feas = finite & (infos.ineq_viol < 1e-2) & \
                (infos.eq_viol < 1e-1)
            margins = torch.stack([plan_margin(ocp.unpack(z)[0])
                                   for z in z_sols])
            ok = feas & (margins > cfg.accept_margin)
            n_primary = min(2, cfg.multi_start)
            primary = torch.arange(cfg.multi_start,
                                   device=ok.device) < n_primary
            ok_primary = (ok & primary).any()
            eligible = ok & torch.where(ok_primary, primary, True)
            score = torch.where(eligible & torch.isfinite(costs), costs,
                                torch.inf)
            idx = torch.where(eligible.any(), torch.argmin(score),
                              torch.argmin(costs))
            z_sol = z_sols[idx]
            info = ipm.IPMInfo(*[x[idx] for x in infos])
            sol_margin = margins[idx]
            m_idx = torch.argmax(torch.where(finite, margins, -torch.inf))
            z_mbest = z_sols[m_idx]
            m_best = torch.where(finite.any(), margins[m_idx],
                                 torch.full_like(margins[0], -torch.inf))

        # --- failure cascade ----------------------------------------------
        sol_cost = ocp.cost(z_sol, params)
        guess_cost = ocp.cost(z_guess, params)
        sol_finite = torch.isfinite(z_sol).all()
        sol_feasible = sol_finite & (info.ineq_viol < 1e-2) & \
            (info.eq_viol < 1e-1)
        sol_realistic = sol_margin > cfg.accept_margin
        # keep the guess when the "optimized" value is worse; with multi-start
        # only when the guess is itself exact-rollout-realistic
        cost_worse = sol_cost > guess_cost
        if cfg.multi_start > 1 and not debug:
            cost_worse = cost_worse & (plan_margin(ocp.unpack(z_guess)[0]) >
                                       cfg.accept_margin)
        use_guess = (~sol_feasible) | (~sol_realistic) | cost_worse
        z_used = torch.where(use_guess, z_guess, z_sol)

        # emergency brake if even the guess is broken; with
        # cfg.brake_on_unreal_guess also when the adopted guess's own exact
        # rollout predicts a collision (its margin is needed only then)
        guess_ok = torch.isfinite(z_guess).all()
        if cfg.brake_on_unreal_guess and (ocp.vmapped or bool(use_guess)):
            margin_g = exact_plan_margin(ocp, params, ocp.unpack(z_guess)[0],
                                         cfg.brake_horizon)
            guess_ok = guess_ok & (~use_guess | (margin_g > cfg.brake_margin))
        use_rescue = torch.zeros_like(guess_ok)
        if cfg.rescue_best_margin and cfg.multi_start > 1 and not debug:
            use_rescue = (use_guess & ~guess_ok & torch.isfinite(z_mbest).all()
                          & (m_best > cfg.brake_margin))
            z_used = torch.where(use_rescue, z_mbest, z_used)
        u_rob = ocp.unpack(z_used)[0]
        exec_plan = guess_ok | ~use_guess | use_rescue
        if cfg.evasive_brake and ocp.vmapped:
            action_u = torch.where(exec_plan, u_rob[0],
                                   _evasive_brake_action(ocp, params))
        elif cfg.evasive_brake and not bool(exec_plan):
            action_u = _evasive_brake_action(ocp, params)
        else:
            v_brake = torch.clamp(ocp.rob_v_prev(params.x0_rob) +
                                  cfg.max_l_dcc * cfg.dt, min=0.0)
            action_u = torch.where(
                exec_plan, u_rob[0],
                torch.stack([v_brake, torch.zeros_like(v_brake)]))

        action = torch.stack([action_u[0], action_u[1] * cfg.dt])
        u_rob_used, u_hums_used, _, slacks_used = ocp.unpack(z_used)
        Xr_used, Xh_used = ocp.rollout(params, u_rob_used, u_hums_used)
        carry_new = CAMPCCarry(
            z_prev=z_used, has_prev=torch.ones_like(carry.has_prev),
            prev_ok=~use_guess,
            num_prev_used=torch.where(use_guess, carry.num_prev_used + 1,
                                      torch.zeros_like(carry.num_prev_used)),
            pred_rob=_rob_pose(ocp, Xr_used[1]), pred_hums=Xh_used[1][:, :2],
            door_stall=door_stall, door_latch=door_latch)

    if debug and not aux:
        u_rob_g, u_hums_g, _, _ = ocp.unpack(z_guess)
        Xr_g, _ = ocp.rollout(params, u_rob_g, u_hums_g)
        return action, carry_new, IN.SolveDebug(
            trace=IN.IterTrace(*raw_trace), info=info,
            viol_sol=IN.constraint_report(ocp, z_sol, params),
            viol_used=IN.constraint_report(ocp, z_used, params),
            used_guess=use_guess, sol_cost=sol_cost, guess_cost=guess_cost,
            slack_max=torch.amax(torch.cat([x.reshape(-1)
                                            for x in slacks_used])),
            plan=Xr_used[:, :2], guess_plan=Xr_g[:, :2],
            human_plans=Xh_used[:, :, :2].transpose(0, 1))
    if not aux:
        return action, carry_new
    Xr_a, Xh_a = WS.exact_human_rollout(ocp, params, u_rob_used)
    d_a = torch.linalg.norm(Xr_a[:, None, :2] - Xh_a[:, :, :2], dim=-1)
    step_aux = CAMPCAux(
        use_guess=use_guess, sol_feasible=sol_feasible,
        sol_realistic=sol_realistic, cost_worse=cost_worse,
        braked=use_guess & ~guess_ok & ~use_rescue, rescued=use_rescue,
        slack_max=torch.amax(torch.cat([x.reshape(-1) for x in slacks_used])),
        exact_margin=torch.amin(d_a - comb[None, :]),
        ineq_viol=info.ineq_viol, eq_viol=info.eq_viol)
    return action, carry_new, step_aux


def make_policy(env_cfg: EnvConfig, mpc_cfg: Optional[MPCConfig] = None,
                settings: Optional[ipm.IPMSettings] = None, device=None,
                batch: bool = False, aux: bool = False):
    """Build (ocp, policy_fn) where policy_fn(state, carry) -> (action,
    carry), on ``device`` (CUDA unless named).

    ``batch=True`` builds the batched policy instead, on an OCP built
    ``vmapped``: (ocp, init_carry_fn, step_fn) for
    ``rollout.batch_rollout_stateful`` and ``harness.evaluate_policy``.
    ``init_carry_fn(cases)`` stacks one fresh carry per case, and
    ``step_fn(states, carries) -> (actions, carries)`` (+ ``CAMPCAux`` with
    ``aux``) is ``campc_action`` ``torch.func.vmap``ped over the leading
    episode axis."""
    if mpc_cfg is None:
        mpc_cfg = MPCConfig(num_hums=env_cfg.max_humans,
                            num_walls=env_cfg.wall_slots, dt=env_cfg.dt)
    ocp = OCP(mpc_cfg, device=device, vmapped=batch)
    if settings is None:
        settings = ipm.realtime_settings(mpc_cfg.num_hums)

    def policy_fn(state: SimState, carry: CAMPCCarry):
        return campc_action(ocp, state, carry, env_cfg, settings, aux=aux)

    if not batch:
        return ocp, policy_fn

    def init_carry_fn(cases):
        return stack([init_carry(ocp) for _ in cases])

    def step_fn(states, carries):
        with ipm.batched_lu_threads(ocp.device):
            return vmap(policy_fn)(states, carries)

    return ocp, init_carry_fn, step_fn

"""CAMPC optimal control problem: cost, dynamics rollout, constraints (twin
of ``sicnav_tpu/mpc/ocp.py``).

The bilevel NLP is a pure function of one dense decision vector

    z = [U_rob (K,2) | U_hums (K_orca,H,3) | Lambda (K_orca,H,n_lam) | slacks]

with the states eliminated by a single-shooting rollout. Every constraint
class of the reference is here: the per-human ORCA-KKT embedding
(stationarity + complementarity with rho = 1e-10), the class-shared scaled
slack variables with their penalties (the T-RO quadratics or the acados
L1/L2 rows), the degeneracy-breaking jitter drawn with numpy's seeded
generator, the 8-state RA-L robot with its capsule, and the stage and wall
margins.

Where the reference maps a per-human or per-stage function with ``vmap``,
the port computes all humans and stages at once by broadcasting. Every
function of z is written for ``torch.func`` (``jacrev``, ``jacfwd``,
``vmap``): no in-place writes, no host reads, no branch on a value.
``residuals`` returns the equality and inequality rows from one rollout,
for the solver, which differentiates both at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen.device import resolve_device
from portbench.reference.frozen.mpc import orca_lines as OL
from portbench.reference.frozen.ops.geometry import dot2, jabs, jclip, jmax

SLACK_SCALING = 1e-3
SLACK_PENAL = 1e9
KKT_RHO = 1e-10


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static CAMPC configuration; the reference's fields and defaults. Each
    field's meaning and the measurements behind its default are documented
    at the reference (``sicnav_tpu.mpc.ocp.MPCConfig``)."""
    horiz: int = 4                    # K
    orca_kkt_horiz: int = 4           # K_orca (0 => = horiz)
    hum_model: str = "orca_casadi_kkt"   # "orca_casadi_kkt" | "cvmm"
    ref_type: str = "point_stab"      # "point_stab" | "goal_tile"
    warmstart: bool = True
    num_hums: int = 3
    num_walls: int = 4
    soft_constraints: bool = True
    priviledged_info: bool = False
    human_max_speed: float = 0.5      # v-max assumption when unprivileged
    pref_speed: float = 0.90
    max_speed: float = 0.95
    max_rev_speed: float = 0.95
    max_rot: float = float(60.0 * np.pi / 180.0)
    max_l_acc: float = 0.5
    max_l_dcc: float = -1.5
    rob_rad_buffer: float = 0.02
    orca_ksi_scaling: float = 1e-2
    orca_vxy_scaling: float = 1.0
    orca_time_horizon: float = 2.5
    orca_time_horizon_obst: float = 1.5
    dt: float = 0.25
    term_q_coeff: float = 100.0
    r_om: float = 0.1
    # robot state model: 4 = T-RO [x,y,th,v_prev]; 8 = RA-L
    # [x,y,sin th,cos th,v_prev,om_prev,vdot,omdot]
    robot_nx: int = 4
    q_x: float = 1.0
    q_y: float = 1.0
    q_theta: float = 0.05
    q_v_prev: float = 2.5
    q_om_prev: float = 0.0
    q_v_prev_dot: float = 3.5
    q_om_prev_dot: float = 0.1
    term_q_theta: float = 2.0
    human_pred_mid: bool = False
    mid_stateful_weights: bool = True
    num_mid_samples: int = 1
    close_to_preds: bool = True
    momentum_warmstart: bool = False
    # capsule: half-length = 0.5 len + len_buffer - 0.5 (wid + wid_buffer),
    # radius = hum_r + 0.5 (wid + wid_buffer)
    robot_capsule: bool = False
    rob_len: float = 0.6
    rob_wid: float = 0.6
    rob_len_buffer: float = 0.01
    rob_wid_buffer: float = 0.01
    stage_margin: float = 0.0
    wall_margin: float = 0.05
    hard_wall_stages: int = 0
    brake_on_unreal_guess: bool = True
    evasive_brake: bool = False
    wall_aware_realism: bool = False
    accept_margin: float = 0.0
    brake_margin: float = 0.0
    rescue_best_margin: bool = False
    brake_horizon: int = 0
    door_yield: bool = False
    door_yield_stall: int = 0
    door_yield_hold_max: int = 16
    door_yield_cooldown: int = 12
    multi_start: int = 1
    adaptive_effort: int = 0
    slack_mode: str = "tro"           # "tro" | "acados"

    @property
    def K(self):
        return self.horiz

    @property
    def K_orca(self):
        k = self.orca_kkt_horiz
        return self.horiz if k == 0 else min(k, self.horiz)

    @property
    def n_lam(self):
        # pairwise (others + robot) + walls + maxvel + ksi
        return self.num_hums + self.num_walls + 2

    @property
    def kkt(self):
        return self.hum_model == "orca_casadi_kkt"

    @property
    def slack_sc(self):
        return SLACK_SCALING if self.slack_mode == "tro" else 1.0

    @property
    def preds_con(self):
        return self.close_to_preds and self.num_mid_samples > 1

    @property
    def n_z(self):
        n = self.K * 2
        if self.kkt:
            n += self.K_orca * self.num_hums * 3
            n += self.K_orca * self.num_hums * self.n_lam
        n += self.n_slack
        return n

    @property
    def n_slack(self):
        # coll(H) + stat + bound + maxvel(H) + ksi(H) + acc + kkt_ineq(H)
        # + kkt_eq(H) + preds(H)
        return 6 * self.num_hums + 3 if self.soft_constraints else 0

    @property
    def orca_params(self) -> OL.OrcaModelParams:
        return OL.OrcaModelParams(time_horizon=self.orca_time_horizon,
                                  time_horizon_obst=self.orca_time_horizon_obst,
                                  dt=self.dt)

    def default_weights(self, device=None) -> "CostWeights":
        """CostWeights filled from the static config, on ``device``."""
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return CostWeights(
            q_x=f32(self.q_x), q_y=f32(self.q_y), q_theta=f32(self.q_theta),
            q_v_prev=f32(self.q_v_prev), q_om_prev=f32(self.q_om_prev),
            q_v_prev_dot=f32(self.q_v_prev_dot),
            q_om_prev_dot=f32(self.q_om_prev_dot),
            term_q_coeff=f32(self.term_q_coeff),
            term_q_theta=f32(self.term_q_theta), r_om=f32(self.r_om))


class CostWeights(NamedTuple):
    """Runtime cost diagonals (0-d tensors), as the RA-L controller passes
    them to its solver per stage."""
    q_x: torch.Tensor
    q_y: torch.Tensor
    q_theta: torch.Tensor
    q_v_prev: torch.Tensor
    q_om_prev: torch.Tensor
    q_v_prev_dot: torch.Tensor
    q_om_prev_dot: torch.Tensor
    term_q_coeff: torch.Tensor
    term_q_theta: torch.Tensor
    r_om: torch.Tensor


class MPCParams(NamedTuple):
    """Per-solve problem data."""
    x0_rob: torch.Tensor       # (nx,) robot state
    goal: torch.Tensor         # (2,) robot goal (may be intermediate)
    hums0: torch.Tensor        # (H, 6) [px, py, vx, vy, gx, gy] (model view)
    hum_radii: torch.Tensor    # (H,) model radii for ORCA lines
    hum_coll_radii: torch.Tensor  # (H,) radii for robot-human collision
    v_max_prefs: torch.Tensor  # (H,) model v_pref bound per human
    rob_radius: torch.Tensor   # ()
    walls: torch.Tensor        # (W, 2, 2)
    wall_mask: torch.Tensor    # (W,)
    x_ref: torch.Tensor        # (K+1, 2 or 5) reference robot states
    mid_samples: torch.Tensor  # (S, H, K+2, 2) forecast samples
    mid_logw0: torch.Tensor    # (S,) joint log-weights
    cost_w: CostWeights


class Slacks(NamedTuple):
    """The slack classes. The three shared ones are () in the reference;
    ``unpack`` gives them as (1,) slices (see ``OCP.robot_step``)."""
    coll: torch.Tensor         # (H,)
    stat: torch.Tensor         # () or (1,)
    bound: torch.Tensor        # () or (1,)
    maxvel: torch.Tensor       # (H,)
    ksi: torch.Tensor          # (H,)
    acc: torch.Tensor          # () or (1,)
    kkt_ineq: torch.Tensor     # (H,)
    kkt_eq: torch.Tensor       # (H,)
    preds: torch.Tensor        # (H,) hums-close-to-preds class


def zero_slacks(H: int, device=None) -> Slacks:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    zH = torch.zeros((H,), dtype=torch.float32, device=device)
    return Slacks(zH, zero, zero, zH, zH, zero, zH, zH, zH)


def _build_jitter(cfg: MPCConfig, device):
    """Degeneracy-breaking constants, one per (human, constraint row), drawn
    once with the reference's seeded generator (rng(5)), in its order."""
    rng = np.random.default_rng(5)
    H, W = cfg.num_hums, cfg.num_walls
    pair_adj = 1.0 + rng.uniform(-5e-4, 5e-4, size=(H, H))
    stat_adj = rng.choice([-1.0, 1.0], size=(H, W)) * rng.uniform(1e-4, 9e-4, size=(H, W))
    ksi_vx = rng.choice([-1.0, 1.0], size=(H,)) * rng.uniform(1e-5, 9e-4, size=(H,))
    ksi_vy = rng.choice([-1.0, 1.0], size=(H,)) * rng.uniform(1e-5, 9e-4, size=(H,))
    return tuple(torch.tensor(np.asarray(x, np.float32), device=device)
                 for x in (pair_adj, stat_adj, ksi_vx, ksi_vy))


def _lse(x):
    return torch.logsumexp(x, dim=-1)


class OCP:
    """Cost / equality / inequality residual functions over z, on one
    device (CUDA unless the caller names another).

    ``vmapped``: the controller built on this OCP runs under
    ``torch.func.vmap`` over episodes (``sicnav_diffusion.make_policy(
    batch=True)``), so nothing on its path may read a value on the host.
    Where the one-episode controller reads a flag to skip work that would
    not change the result, it computes that work and selects instead, as
    the reference's ``lax.cond`` does under ``jax.vmap``."""

    def __init__(self, cfg: MPCConfig, device=None, vmapped: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vmapped = vmapped
        self.jitter = _build_jitter(cfg, self.device)
        H = cfg.num_hums
        self._eye_h = torch.eye(H, dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------ z
    def unpack(self, z):
        cfg = self.cfg
        K, Ko, H, nl = cfg.K, cfg.K_orca, cfg.num_hums, cfg.n_lam
        i = 0
        u_rob = z[i:i + K * 2].reshape(K, 2)
        i += K * 2
        if cfg.kkt:
            u_hums = z[i:i + Ko * H * 3].reshape(Ko, H, 3)
            i += Ko * H * 3
            lam = z[i:i + Ko * H * nl].reshape(Ko, H, nl)
            i += Ko * H * nl
        else:
            u_hums = z.new_zeros((Ko, H, 3))
            lam = z.new_zeros((Ko, H, nl))
        if cfg.soft_constraints:
            s = z[i:]
            slacks = Slacks(
                coll=s[0:H], stat=s[H:H + 1], bound=s[H + 1:H + 2],
                maxvel=s[H + 2:2 * H + 2], ksi=s[2 * H + 2:3 * H + 2],
                acc=s[3 * H + 2:3 * H + 3], kkt_ineq=s[3 * H + 3:4 * H + 3],
                kkt_eq=s[4 * H + 3:5 * H + 3], preds=s[5 * H + 3:6 * H + 3])
        else:
            zero, zH = z.new_zeros((1,)), z.new_zeros((H,))
            slacks = Slacks(zH, zero, zero, zH, zH, zero, zH, zH, zH)
        return u_rob, u_hums, lam, slacks

    def pack(self, u_rob, u_hums, lam, slacks: Slacks):
        cfg = self.cfg
        parts = [u_rob.reshape(-1)]
        if cfg.kkt:
            parts += [u_hums.reshape(-1), lam.reshape(-1)]
        if cfg.soft_constraints:
            parts += [slacks.coll, slacks.stat.reshape(1),
                      slacks.bound.reshape(1), slacks.maxvel, slacks.ksi,
                      slacks.acc.reshape(1), slacks.kkt_ineq, slacks.kkt_eq,
                      slacks.preds]
        return torch.cat(parts)

    # ------------------------------------------------------------ dynamics
    def u_hums_at(self, u_hums, k: int):
        """Human decision vars at stage k (repeated beyond K_orca)."""
        return u_hums[min(k, self.cfg.K_orca - 1)]

    def robot_step(self, xr, u):
        """One robot model step under controls u = (v, om): the RA-L
        sin/cos-heading model or the T-RO unicycle with lookahead heading.
        Elements are taken as 1-element slices: torch.func's forward mode
        (torch 2.13) gives a 0-d tensor times a Python float a float64
        tangent, which the Lagrangian Hessian cannot mix with float32."""
        dt = self.cfg.dt
        v, om = u[0:1], u[1:2]
        if self.cfg.robot_nx == 8:
            s, c = xr[2:3], xr[3:4]
            s_next = s * torch.cos(om * dt) + c * torch.sin(om * dt)
            c_next = c * torch.cos(om * dt) - s * torch.sin(om * dt)
            return torch.cat([
                xr[0:1] + dt * v * c_next, xr[1:2] + dt * v * s_next,
                s_next, c_next, v, om, (v - xr[4:5]) / dt,
                (om - xr[5:6]) / dt])
        th_next = xr[2:3] + dt * om
        return torch.cat([xr[0:1] + dt * v * torch.cos(th_next),
                          xr[1:2] + dt * v * torch.sin(th_next), th_next, v])

    def rollout(self, params: MPCParams, u_rob, u_hums):
        """Single-shooting rollout: (X_rob (K+1, nx), X_hums (K+1, H, 6)).
        With ``human_pred_mid`` the human goals evolve through the horizon
        by the stateful joint MID-sample log-weight dynamics."""
        cfg = self.cfg
        dt, sv = cfg.dt, cfg.orca_vxy_scaling
        xr, xh, logw = params.x0_rob, params.hums0, params.mid_logw0
        xs_r, xs_h = [xr], [xh]
        for k in range(cfg.K):
            xr = self.robot_step(xr, u_rob[k])
            vel = sv * self.u_hums_at(u_hums, k)[:, :2] if cfg.kkt \
                else xh[:, 2:4]
            p_next = xh[:, :2] + vel * dt
            if cfg.human_pred_mid:
                S_t = params.mid_samples[:, :, k + 1]              # (S, H, 2)
                d2 = ((S_t - p_next[None]) ** 2).sum(-1)           # (S, H)
                avg_d2 = d2.mean(dim=1)
                lw = jmax(-(2.0 ** 10) * avg_d2, -20.0)
                lw = lw - _lse(lw)
                if cfg.mid_stateful_weights:
                    lw = logw + lw
                    lw = lw - _lse(lw)
                w = jmax(torch.exp(lw), 1e-10)
                goals = torch.einsum("s,she->he", w,
                                     params.mid_samples[:, :, k + 2])
                logw = lw
            else:
                goals = xh[:, 4:6]
            xh = torch.cat([p_next, vel, goals], dim=-1)
            xs_r.append(xr)
            xs_h.append(xh)
        return torch.stack(xs_r), torch.stack(xs_h)

    # ---------------------------------------------------------------- cost
    def tracking_cost(self, params: MPCParams, X_rob, u_rob):
        """T-RO: 0.5 |p_k - p_ref|^2 (+ terminal coeff) + 0.5 r_om om^2.
        RA-L 8-state: the diagonal-weighted residual with the
        sin(th - th_ref) heading term and the accel-state penalties."""
        cfg = self.cfg
        cw = params.cost_w
        ones = X_rob.new_ones((cfg.K,))
        dp = X_rob[:, :2] - params.x_ref[:, :2]
        if cfg.robot_nx == 8:
            sin_res = (X_rob[:, 2] * params.x_ref[:, 3] -
                       X_rob[:, 3] * params.x_ref[:, 2])
            w_pos = torch.cat([ones, cw.term_q_coeff.reshape(1)])
            w_th = torch.cat([cw.q_theta * ones, cw.term_q_theta.reshape(1)])
            # 0.5 * sum(x) is taken as sum(0.5 * x), the same number (a
            # power of two), so no 0-d tensor meets a Python float
            cost = torch.sum(0.5 * (
                w_pos * (cw.q_x * dp[:, 0] ** 2 + cw.q_y * dp[:, 1] ** 2)))
            cost = cost + torch.sum(0.5 * (w_th * sin_res ** 2))
            # the speed tracks the rolled reference's cruise speed
            v_ref = params.x_ref[:, 4] if params.x_ref.shape[-1] > 4 else 0.0
            cost = cost + torch.sum(0.5 * (
                cw.q_v_prev * (X_rob[:, 4] - v_ref) ** 2 +
                cw.q_om_prev * X_rob[:, 5] ** 2 +
                cw.q_v_prev_dot * X_rob[:, 6] ** 2 +
                cw.q_om_prev_dot * X_rob[:, 7] ** 2))
            return cost + 0.5 * cw.r_om * torch.sum(u_rob[:, 1] ** 2)
        w = torch.cat([ones, cw.term_q_coeff.reshape(1)])
        cost = torch.sum(0.5 * (w * torch.sum(dp * dp, dim=-1)))
        return cost + 0.5 * cw.r_om * torch.sum(u_rob[:, 1] ** 2)

    def slack_cost(self, slacks: Slacks):
        """The T-RO penalty terms, or the RA-L acados L1/L2 row penalties
        scaled by each class's row multiplicity."""
        cfg = self.cfg
        if not cfg.soft_constraints:
            return slacks.stat.new_zeros(())
        K, Ko, W = cfg.K, cfg.K_orca, cfg.num_walls
        if cfg.slack_mode == "acados":
            def pen(s, rows):
                return rows * (1e4 * s ** 2 + 10.0 * jabs(s))
            tot = torch.sum(pen(slacks.coll, K + 1))
            tot = tot + torch.sum(pen(slacks.stat, W * (K + 1)))
            tot = tot + torch.sum(pen(slacks.bound, 4 * K))
            tot = tot + torch.sum(pen(slacks.maxvel, K))
            tot = tot + torch.sum(pen(slacks.ksi, K))
            tot = tot + torch.sum(pen(slacks.acc, 3 * K))
            tot = tot + torch.sum(pen(slacks.kkt_ineq, 2 * Ko * cfg.n_lam))
            tot = tot + torch.sum(1e4 * Ko * (3 + cfg.n_lam) *
                                  slacks.kkt_eq ** 2)
            return tot + torch.sum(pen(slacks.preds, K))
        sc, c = SLACK_SCALING, SLACK_PENAL
        tot = torch.sum(101.0 * (K + 1) * c * (sc * slacks.coll) ** 2)
        tot = tot + torch.sum(101.0 * W * (K + 1) * c * (sc * slacks.stat) ** 2)
        tot = tot + torch.sum(101.0 * K * c * (sc * slacks.bound) ** 2)
        tot = tot + torch.sum(101.0 * K * c * (sc * slacks.maxvel) ** 2)
        tot = tot + torch.sum(101.0 * K * c * (sc * slacks.ksi) ** 2)
        tot = tot + torch.sum(K * c * (sc * slacks.acc) ** 2)
        tot = tot + torch.sum(101.0 * Ko * c * (sc * slacks.kkt_ineq) ** 2)
        tot = tot + torch.sum(0.1 * Ko * c * (sc * slacks.kkt_eq) ** 2)
        return tot + torch.sum(K * c * (sc * slacks.preds) ** 2)

    def cost(self, z, params: MPCParams):
        u_rob, u_hums, _, slacks = self.unpack(z)
        X_rob, _ = self.rollout(params, u_rob, u_hums)
        return self.tracking_cost(params, X_rob, u_rob) + \
            self.slack_cost(slacks)

    # ------------------------------------------------------ robot accessors
    def rob_heading(self, xr):
        """(sin th, cos th) of robot state(s) (..., nx) in either mode."""
        if self.cfg.robot_nx == 8:
            return xr[..., 2], xr[..., 3]
        return torch.sin(xr[..., 2]), torch.cos(xr[..., 2])

    def rob_v_prev(self, xr):
        return xr[..., 4] if self.cfg.robot_nx == 8 else xr[..., 3]

    def rob_vel(self, xr):
        s, c = self.rob_heading(xr)
        return self.rob_v_prev(xr)[..., None] * torch.stack([c, s], dim=-1)

    # ------------------------------------------------- human ORCA geometry
    def human_lines(self, params: MPCParams, xr, xh):
        """Every human's (n_lam - 2) half-plane rows: pairwise (the others,
        and the robot in the human's own slot), then walls. xr (..., nx),
        xh (..., H, 6). Returns (norms (..., H, L, 2), scalars (..., H, L),
        adj (H, L)), adj being the jitter coefficient of sk * ksi per row."""
        cfg = self.cfg
        op = cfg.orca_params
        pair_adj, stat_adj, _, _ = self.jitter
        eye = self._eye_h[..., None]                      # [a, b, 1]

        pos, vel = xh[..., :2], xh[..., 2:4]              # (..., H, 2)
        rad = params.hum_radii
        pos_a, vel_a = pos[..., :, None, :], vel[..., :, None, :]
        # slot a of human a's pairwise rows is the robot
        pos_b = torch.where(eye, xr[..., None, None, :2], pos[..., None, :, :])
        vel_b = torch.where(eye, self.rob_vel(xr)[..., None, None, :],
                            vel[..., None, :, :])
        rad_b = torch.where(self._eye_h, params.rob_radius, rad[None, :])
        n_pair, s_pair = OL.pairwise_line(pos_a, vel_a, pos_b, vel_b,
                                          rad[:, None], rad_b, op)
        n_stat, s_stat = OL.static_line(pos_a, vel_a, rad[:, None],
                                        params.walls, params.wall_mask, op)
        norms = torch.cat([n_pair, n_stat], dim=-2)
        scalars = torch.cat([s_pair, s_stat], dim=-1)
        return norms, scalars, torch.cat([pair_adj, stat_adj], dim=-1)

    def _g_from_lines(self, params, norms, scalars, adj, uh):
        cfg = self.cfg
        sv, sk = cfg.orca_vxy_scaling, cfg.orca_ksi_scaling
        _, _, ksi_vx, ksi_vy = self.jitter
        v = sv * uh[..., :2]                               # (..., H, 2)
        ksi = uh[..., 2]
        g_lines = -dot2(norms, v[..., None, :]) + scalars - \
            adj * sk * ksi[..., None]
        g_maxvel = dot2(v, v) - params.v_max_prefs ** 2
        g_ksi = ksi_vx * v[..., 0] + ksi_vy * v[..., 1] - sk * ksi
        return torch.cat([g_lines, g_maxvel[..., None], g_ksi[..., None]],
                         dim=-1)

    def human_orca_g(self, params: MPCParams, xr, xh, uh, lines=None):
        """Inequality rows g (..., H, n_lam) of every human's relaxed-ORCA
        problem at stage(s) xr, xh; uh (..., H, 3) raw [vx, vy, ksi].
        ``lines``: human_lines(params, xr, xh) when already at hand."""
        if lines is None:
            lines = self.human_lines(params, xr, xh)
        return self._g_from_lines(params, *lines, uh)

    def human_kkt_rows(self, params: MPCParams, xr, xh, uh, lam, lines=None):
        """(g, stationarity) of the embedded lower-level KKT systems, with
        the stationarity gradient written analytically (the constraint
        gradients in (v, ksi) are closed-form), which keeps the upper-level
        Hessian free of third-order AD through the ORCA geometry.
        ``lines`` as in human_orca_g."""
        cfg = self.cfg
        sv, sk = cfg.orca_vxy_scaling, cfg.orca_ksi_scaling
        _, _, ksi_vx, ksi_vy = self.jitter
        if lines is None:
            lines = self.human_lines(params, xr, xh)
        norms, scalars, adj = lines
        g = self._g_from_lines(params, norms, scalars, adj, uh)

        v = sv * uh[..., :2]
        ksi = uh[..., 2]
        v_pref = OL.v_pref_from_state(xh[..., :2], xh[..., 4:6],
                                      params.v_max_prefs)
        lam_lines = lam[..., :-2]
        lam_mv = lam[..., -2]
        lam_ksi = lam[..., -1]
        # d/d(uh[:2]) of [cost + lam^T g]
        grad_v = (2.0 * sv * (v - v_pref) -
                  sv * (norms * lam_lines[..., None]).sum(dim=-2) +
                  2.0 * sv * v * lam_mv[..., None] +
                  sv * torch.stack([ksi_vx, ksi_vy], dim=-1) *
                  lam_ksi[..., None])
        # d/d(ksi)
        grad_ksi = (200.0 * sk * sk * ksi - sk * (adj * lam_lines).sum(-1) -
                    sk * lam_ksi)
        return g, torch.cat([grad_v, grad_ksi[..., None]], dim=-1)

    # ---------------------------------------------------------- residuals
    def _eq_from(self, params, X_rob, X_hums, u_hums, lam, slacks):
        cfg = self.cfg
        Ko = cfg.K_orca
        g, grad = self.human_kkt_rows(params, X_rob[:Ko], X_hums[:Ko],
                                      u_hums, lam)
        comp = lam * g - KKT_RHO
        res = torch.cat([grad, comp], dim=-1)
        res = res - cfg.slack_sc * slacks.kkt_eq[:, None]
        return res.reshape(-1), g

    def eq_residuals(self, z, params: MPCParams):
        """KKT equality block: stationarity + complementarity, minus the
        shared per-human eq slack. (K_orca * H * (3 + n_lam),)."""
        if not self.cfg.kkt:
            return z.new_zeros((0,))
        u_rob, u_hums, lam, slacks = self.unpack(z)
        X_rob, X_hums = self.rollout(params, u_rob, u_hums)
        return self._eq_from(params, X_rob, X_hums, u_hums, lam, slacks)[0]

    def _groups_from(self, params, X_rob, X_hums, u_rob, u_hums, lam,
                     g_kkt=None):
        """Raw (not slack-shifted) inequality rows by constraint class."""
        cfg = self.cfg
        K, Ko = cfg.K, cfg.K_orca
        g = {}
        stages = torch.arange(K + 1, device=X_rob.device,
                              dtype=X_rob.dtype)[:, None]

        # robot-human collision, stages 0..K
        if cfg.robot_capsule:
            corr_wid = cfg.rob_wid + cfg.rob_wid_buffer
            half_len = max(0.5 * cfg.rob_len + cfg.rob_len_buffer -
                           0.5 * corr_wid, 0.0)
            comb = (params.hum_coll_radii[None, :] + 0.5 * corr_wid +
                    cfg.stage_margin * stages)
            if cfg.robot_nx == 8:
                heading = torch.stack([X_rob[:, 3], X_rob[:, 2]], -1)
            else:
                heading = torch.stack([torch.cos(X_rob[:, 2]),
                                       torch.sin(X_rob[:, 2])], -1)
            a0 = X_rob[:, :2] - half_len * heading
            seg = 2.0 * half_len * heading
            w_vec = X_hums[:, :, :2] - a0[:, None, :]
            t = jclip(torch.sum(w_vec * seg[:, None, :], -1) /
                      jmax(torch.sum(seg * seg, -1), 1e-9)[:, None],
                      0.0, 1.0)
            cp = a0[:, None, :] + t[..., None] * seg[:, None, :]
            d = X_hums[:, :, :2] - cp
            g["coll"] = -(torch.sum(d * d, -1) - comb ** 2)
        else:
            comb = (params.hum_coll_radii[None, :] + params.rob_radius +
                    cfg.rob_rad_buffer + 0.01 + cfg.stage_margin * stages)
            d = X_rob[:, None, :2] - X_hums[:, :, :2]
            g["coll"] = -(torch.sum(d * d, -1) - comb ** 2)

        # robot-wall capsule rows, stages 0..K, with the buffer rule
        rob_r = params.rob_radius
        reach = cfg.max_speed * cfg.dt
        stat_buf = torch.where(reach >= rob_r, reach - rob_r + 0.01,
                               torch.full_like(rob_r, 0.05))
        comb_rad = rob_r + stat_buf + cfg.wall_margin
        p1 = params.walls[:, 0][:, None, :]                   # (W, 1, 2)
        vv = params.walls[:, 1] - params.walls[:, 0]           # (W, 2)
        ww = X_rob[None, :, :2] - p1                           # (W, K+1, 2)
        t = jclip(torch.sum(ww * vv[:, None, :], -1) /
                  jmax(dot2(vv, vv), 1e-12)[:, None], 0.0, 1.0)
        cp = p1 + t[..., None] * vv[:, None, :]
        dvec = X_rob[None, :, :2] - cp
        val = -(torch.sum(dvec * dvec, -1) - comb_rad ** 2)
        g["stat"] = torch.where(params.wall_mask[:, None], val,
                                torch.full_like(val, -1.0))   # (W, K+1)

        # robot input bounds
        lb = torch.tensor([-cfg.max_rev_speed, -cfg.max_rot + 0.001],
                          dtype=u_rob.dtype, device=u_rob.device)
        ub = torch.tensor([cfg.max_speed, cfg.max_rot], dtype=u_rob.dtype,
                          device=u_rob.device)
        g["bound"] = torch.cat([(u_rob - ub[None]).reshape(-1),
                                (lb[None] - u_rob).reshape(-1)])

        # accel constraints
        v_prev = self.rob_v_prev(X_rob[:K])
        v_u = u_rob[:, 0]
        diff = jabs(v_u) - jabs(v_prev)
        upper = diff - cfg.max_l_acc * cfg.dt
        low_b = torch.maximum(torch.full_like(v_prev, cfg.max_l_dcc * cfg.dt),
                              -jabs(v_prev))
        lower = -diff + low_b
        sign = -torch.sign(v_prev) * v_u - 1e-5
        g["acc"] = torch.stack([upper, lower, sign], -1)      # (K, 3)

        if cfg.kkt:
            sv, sk = cfg.orca_vxy_scaling, cfg.orca_ksi_scaling
            uh_full = torch.stack([self.u_hums_at(u_hums, k)
                                   for k in range(K)])        # (K, H, 3)
            vmag2 = torch.sum((sv * uh_full[:, :, :2]) ** 2, -1)
            g["maxvel"] = vmag2 - params.v_max_prefs[None, :] ** 2
            _, _, ksi_vx, ksi_vy = self.jitter
            g["ksi"] = (ksi_vx[None, :] * sv * uh_full[:, :, 0] +
                        ksi_vy[None, :] * sv * uh_full[:, :, 1] -
                        sk * uh_full[:, :, 2])
            # primal feasibility g <= 0, dual feasibility -lam <= 0
            if g_kkt is None:
                g_kkt = self.human_orca_g(params, X_rob[:Ko], X_hums[:Ko],
                                          u_hums)
            g["kkt"] = torch.cat([g_kkt, -lam], dim=-1)     # (Ko, H, 2 n_lam)

        if cfg.preds_con:
            # each human's next position within sqrt(0.5 max-NN-spread^2)
            # of its closest sample; a degenerate spread relaxes to 10
            S_t = params.mid_samples[:, :, 1:K + 1].permute(2, 0, 1, 3)
            p_next = X_hums[1:K + 1, :, :2]                   # (K, H, 2)
            d2 = torch.sum((S_t - p_next[:, None]) ** 2, -1)  # (K, S, H)
            closest = torch.amin(d2, dim=1)
            pair = torch.sum((S_t[:, :, None] - S_t[:, None, :]) ** 2, -1)
            nS = pair.shape[1]
            pair = pair + torch.eye(nS, dtype=pair.dtype,
                                    device=pair.device)[:, :, None] * 1e9
            nn = torch.amin(pair, dim=2)                      # (K, S, H)
            max_nn = torch.amax(nn, dim=1)                    # (K, H)
            max_nn = torch.where(max_nn > 1e-3, max_nn,
                                 torch.full_like(max_nn, 10.0))
            g["preds"] = closest - 0.5 * max_nn
        return g

    def _ineq_groups(self, z, params: MPCParams):
        u_rob, u_hums, lam, _ = self.unpack(z)
        X_rob, X_hums = self.rollout(params, u_rob, u_hums)
        return self._groups_from(params, X_rob, X_hums, u_rob, u_hums, lam)

    def _ineq_from(self, g, slacks):
        cfg = self.cfg
        sc = cfg.slack_sc
        stat_soft = self._stat_soft_mask(g["stat"])
        rows = [
            (g["coll"] - sc * slacks.coll[None, :]).reshape(-1),
            (g["stat"] - sc * slacks.stat * stat_soft[None, :]).reshape(-1),
            (g["bound"] - sc * slacks.bound).reshape(-1),
            (g["acc"] - sc * slacks.acc).reshape(-1),
        ]
        if cfg.kkt:
            rows += [
                (g["maxvel"] - sc * slacks.maxvel[None, :]).reshape(-1),
                (g["ksi"] - sc * slacks.ksi[None, :]).reshape(-1),
                (g["kkt"] - sc * slacks.kkt_ineq[None, :, None]).reshape(-1),
            ]
        if cfg.preds_con:
            rows.append((g["preds"] - sc * slacks.preds[None, :]).reshape(-1))
        if cfg.soft_constraints:
            rows += [-slacks.coll, -slacks.stat.reshape(1),
                     -slacks.bound.reshape(1), -slacks.maxvel, -slacks.ksi,
                     -slacks.acc.reshape(1), -slacks.kkt_ineq, -slacks.preds]
        return torch.cat(rows)

    def ineq_residuals(self, z, params: MPCParams):
        """All inequality rows (<= 0), slack-shifted."""
        _, _, _, slacks = self.unpack(z)
        return self._ineq_from(self._ineq_groups(z, params), slacks)

    def residuals(self, z, params: MPCParams):
        """(eq_residuals, ineq_residuals) from one rollout and one set of
        human lines: the same rows, computed once for both."""
        u_rob, u_hums, lam, slacks = self.unpack(z)
        X_rob, X_hums = self.rollout(params, u_rob, u_hums)
        if self.cfg.kkt:
            c_e, g_kkt = self._eq_from(params, X_rob, X_hums, u_hums, lam,
                                       slacks)
        else:
            c_e, g_kkt = z.new_zeros((0,)), None
        g = self._groups_from(params, X_rob, X_hums, u_rob, u_hums, lam,
                              g_kkt)
        return c_e, self._ineq_from(g, slacks)

    def _stat_soft_mask(self, like):
        """(K+1,) 1 where the robot-wall row is slacked, 0 where it is hard
        (stages 1..hard_wall_stages; stage 0 always slacked)."""
        cfg = self.cfg
        ks = torch.arange(cfg.K + 1, device=like.device)
        hard = (ks >= 1) & (ks <= cfg.hard_wall_stages)
        return torch.where(hard, 0.0, 1.0).to(like.dtype)

    def infer_slacks(self, z, params: MPCParams):
        """Honest slack values for a primal guess: the per-class maximum raw
        violation; the eq slacks the mean residual per human."""
        cfg = self.cfg
        u_rob, u_hums, lam, _ = self.unpack(z)
        g = self._ineq_groups(z, params)
        sc = cfg.slack_sc
        zH = z.new_zeros((cfg.num_hums,))

        def pos_max(x, dim=None):
            m = torch.amax(x) if dim is None else torch.amax(x, dim=dim)
            return torch.clamp(m, min=0.0) / sc

        slacks = Slacks(
            coll=pos_max(g["coll"], dim=0),
            # the stat slack absorbs only slacked rows
            stat=pos_max(g["stat"] * self._stat_soft_mask(g["stat"])[None, :]),
            bound=pos_max(g["bound"]),
            maxvel=pos_max(g["maxvel"], dim=0) if cfg.kkt else zH,
            ksi=pos_max(g["ksi"], dim=0) if cfg.kkt else zH,
            acc=pos_max(g["acc"]),
            kkt_ineq=pos_max(g["kkt"], dim=(0, 2)) if cfg.kkt else zH,
            kkt_eq=zH,
            preds=pos_max(g["preds"], dim=0) if cfg.preds_con else zH)
        z2 = self.pack(u_rob, u_hums, lam, slacks)
        if cfg.kkt:
            # the shared slack minimizing the L2 eq residual per human
            res = self.eq_residuals(z2, params).reshape(
                cfg.K_orca, cfg.num_hums, 3 + cfg.n_lam)
            eq_s = torch.mean(res, dim=(0, 2)) / sc
            z2 = self.pack(u_rob, u_hums, lam, slacks._replace(kkt_eq=eq_s))
        return z2

    # ------------------------------------------------------------ sizes
    @property
    def n_eq(self):
        cfg = self.cfg
        return cfg.K_orca * cfg.num_hums * (3 + cfg.n_lam) if cfg.kkt else 0

    @property
    def n_ineq(self):
        cfg = self.cfg
        K, Ko, H, W = cfg.K, cfg.K_orca, cfg.num_hums, cfg.num_walls
        n = (K + 1) * H + (K + 1) * W + 2 * 2 * K + 3 * K
        if cfg.kkt:
            n += 2 * K * H + 2 * Ko * H * cfg.n_lam
        if cfg.preds_con:
            n += K * H
        if cfg.soft_constraints:
            n += 5 * H + 3
        return n


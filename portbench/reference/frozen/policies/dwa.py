"""Dynamic Window Approach robot policy (twin of
``sicnav_tpu/policies/dwa.py``).

The whole (v, w) window is a static ``n_v`` x ``n_w`` grid; every candidate
trajectory is rolled out at once (a batch dimension over candidates, a host
loop over the short horizon), and scoring is one argmax.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.func import vmap

from portbench.reference.frozen.env.types import EnvConfig, SimState
from portbench.reference.frozen.ops.geometry import linspace, norm2, point_to_segment_dist


@dataclasses.dataclass(frozen=True)
class DWAConfig:
    """Defaults = the reference's DWA configuration."""
    max_speed: float = 1.0          # robot v_pref
    min_speed: float = -1.0
    max_accel: float = 0.5
    max_delta_yaw_rate: float = 1.04
    max_d: float = 2.0
    dt: float = 0.25
    predict_time: float = 2.5
    to_goal_cost_gain: float = 0.5
    speed_cost_gain: float = 1.0
    obstacle_cost_gain: float = 2.0
    robot_stuck_flag_cons: float = 0.01
    robot_radius: float = 0.25
    max_yaw_rate: float = 40.0 * math.pi / 180.0
    n_v: int = 8                    # static window sample counts
    n_w: int = 64

    @property
    def horizon(self) -> int:
        return int(self.predict_time / self.dt) + 1


def _motion_step(state, v, w, dt):
    """Exact arc motion model; state (..., 3) = (x, y, theta)."""
    x, y, th = state[..., 0], state[..., 1], state[..., 2]
    straight = w.abs() < 0.01
    th2 = th + w * dt
    x_s = x + v * torch.cos(th2) * dt
    y_s = y + v * torch.sin(th2) * dt
    safe_w = torch.where(straight, torch.ones_like(w), w)
    x_a = x + (v / safe_w) * (torch.sin(th2) - torch.sin(th))
    y_a = y + (v / safe_w) * (torch.cos(th) - torch.cos(th2))
    return torch.stack([torch.where(straight, x_s, x_a),
                        torch.where(straight, y_s, y_a), th2], dim=-1)


def _eval_candidate(x0, v, w, goal, obs_pos, obs_rad, obs_mask,
                    walls, wall_mask, cfg: DWAConfig):
    """Roll out (v, w) candidates (C,) from x0 (5,); returns (head, dist,
    admissible), each (C,)."""
    C = v.shape[0]
    state = x0[:3].expand(C, 3)
    active = torch.ones(C, dtype=torch.bool, device=v.device)
    dist = torch.full((C,), cfg.max_d, dtype=torch.float32, device=v.device)

    # distances from the start pose do not change over the horizon
    d0_agents = norm2(x0[None, :2] - obs_pos)                      # (N,)
    d0_walls = point_to_segment_dist(walls[:, 0], walls[:, 1],
                                     x0[None, :2])                 # (W,)
    inf = torch.full((C,), math.inf, dtype=torch.float32, device=v.device)
    for _ in range(cfg.horizon):
        nxt = _motion_step(state, v, w, cfg.dt)
        # stop rolling once within half a radius of goal
        reached = norm2(nxt[:, :2] - goal) <= cfg.robot_radius * 0.5
        state = torch.where(active[:, None], nxt, state)

        # obstacle collision at this trajectory point -> distance from start
        pt = state[:, None, :2]
        d_agents = norm2(pt - obs_pos)                             # (C, N)
        hit_a = obs_mask & (d_agents < cfg.robot_radius + obs_rad + 0.01)
        da = torch.where(hit_a & active[:, None], d0_agents, inf[:, None]).amin(-1)

        d_walls = point_to_segment_dist(walls[:, 0], walls[:, 1], pt)
        hit_w = wall_mask & (d_walls < cfg.robot_radius + 0.02)
        dw = torch.where(hit_w & active[:, None], d0_walls, inf[:, None]).amin(-1)

        dist = torch.minimum(dist, torch.minimum(da, dw))
        active = active & ~reached

    dist = torch.clamp(dist, max=cfg.max_d)
    # admissibility: enough room to stop
    inadmissible = (v > torch.sqrt(2.0 * dist * cfg.max_accel)) | \
        (w > torch.sqrt(2.0 * dist * cfg.max_delta_yaw_rate))

    # heading score at trajectory end
    err = torch.atan2(goal[1] - state[:, 1], goal[0] - state[:, 0]) - state[:, 2]
    cost_angle = torch.atan2(torch.sin(err), torch.cos(err)).abs()
    head = math.pi - cost_angle
    return head, dist, ~inadmissible


def dwa_action(x, goal, obs_pos, obs_rad, obs_mask, walls, wall_mask,
               cfg: DWAConfig):
    """DWA control: x = [px, py, theta, v, w]; returns (v, w) maximizing the
    normalized objective over the dynamic window."""
    v0, w0 = x[3], x[4]
    v_max = torch.clamp(v0 + cfg.max_accel * cfg.dt, max=cfg.max_speed)
    v_min = torch.clamp(v0 - cfg.max_accel * cfg.dt, min=cfg.min_speed)
    v_min = torch.minimum(v_min, v_max - cfg.max_accel * cfg.dt)
    w_max = torch.clamp(w0 + cfg.max_delta_yaw_rate * cfg.dt,
                        max=cfg.max_yaw_rate)
    w_min = torch.clamp(w0 - cfg.max_delta_yaw_rate * cfg.dt,
                        min=-cfg.max_yaw_rate)
    w_min = torch.minimum(w_min, w_max - cfg.max_delta_yaw_rate * cfg.dt)

    vs = linspace(v_min, v_max, cfg.n_v)
    ws = linspace(w_min, w_max, cfg.n_w)
    vv, ww = torch.meshgrid(vs, ws, indexing="ij")
    vv, ww = vv.reshape(-1), ww.reshape(-1)

    head, dist, admissible = _eval_candidate(
        x, vv, ww, goal, obs_pos, obs_rad, obs_mask, walls, wall_mask, cfg)

    score = (cfg.to_goal_cost_gain * head / math.pi +
             cfg.obstacle_cost_gain * dist / cfg.max_d +
             cfg.speed_cost_gain * vv / cfg.max_speed)
    score = torch.where(admissible, score, torch.zeros_like(score))
    best = torch.argmax(score)
    ok = admissible[best]
    v_sel = torch.where(ok, vv[best], 0.0)
    w_sel = torch.where(ok, ww[best], 0.0)
    # anti-stuck spin
    stuck = (v_sel.abs() < cfg.robot_stuck_flag_cons) & \
        (v0.abs() < cfg.robot_stuck_flag_cons) & ok
    w_sel = torch.where(stuck, -cfg.max_delta_yaw_rate, w_sel)
    return torch.stack([v_sel, w_sel])


def dwa_policy(state: SimState, env_cfg: EnvConfig, cfg: DWAConfig = None):
    """SimState -> unicycle action (v, r) with r = w * dt."""
    if cfg is None:
        cfg = DWAConfig(max_speed=env_cfg.robot_v_pref,
                        min_speed=-env_cfg.robot_v_pref,
                        robot_radius=env_cfg.robot_radius, dt=env_cfg.dt)
    x = torch.stack([state.r_pos[0], state.r_pos[1], state.r_theta,
                     norm2(state.r_vel), state.r_omega])
    u = dwa_action(x, state.r_goal, state.h_pos, state.h_radius, state.h_mask,
                   state.walls, state.wall_mask, cfg)
    return torch.stack([u[0], u[1] * env_cfg.dt])


def dwa_policy_batch(states: SimState, env_cfg: EnvConfig,
                     cfg: DWAConfig = None):
    """``dwa_policy`` for states with a leading episode axis: (B, 2)
    actions, one vmapped call (the batched policy of
    ``rollout.batch_rollout`` and the harness)."""
    return vmap(lambda s: dwa_policy(s, env_cfg, cfg))(states)

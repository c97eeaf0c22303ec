"""Human policies (twin of ``sicnav_tpu/env/human_policies.py``).

Maps the sim state to a (..., H, 2) tensor of holonomic velocity actions
for every human slot at once, on the state's leading episode axes: ORCA,
ORCA-plus, the Social Forces Model and linear humans.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.env.types import EnvConfig, SimState
from portbench.reference.frozen.ops import orca as orca_ops
from portbench.reference.frozen.ops.geometry import closest_point_on_segment, norm2


def _orca_actions(state: SimState, cfg: EnvConfig, plus: bool) -> torch.Tensor:
    """ORCA(-plus) for all humans in one batched call. Each human is RVO2
    "agent 0" of its own one-step sim; its neighbours are the other humans
    and the robot (if visible). The state may carry leading episode axes
    B; the B x H acting humans go to the LP as one batch."""
    H = cfg.max_humans
    lead = state.t.shape
    dev = state.h_pos.device
    params = orca_ops.OrcaParams(
        neighbor_dist=cfg.orca_neighbor_dist,
        time_horizon=cfg.orca_time_horizon,
        time_horizon_obst=cfg.orca_time_horizon_obst,
        dt=cfg.dt)
    inflation = 0.01 + cfg.safety_space

    # neighbour slot layout per acting human i: all humans (self masked) + robot
    npos = torch.cat([state.h_pos, state.r_pos[..., None, :]], dim=-2)
    nvel = torch.cat([state.h_vel, state.r_vel[..., None, :]], dim=-2)
    nrad = torch.cat([state.h_radius, state.r_radius[..., None]],
                     dim=-1) + inflation
    robot_vis = torch.full((*lead, 1), cfg.robot_visible, dtype=torch.bool,
                           device=dev)
    base_mask = torch.cat([state.h_mask, robot_vis], dim=-1)
    not_self = ~torch.eye(H, H + 1, dtype=torch.bool, device=dev)
    nmask = base_mask[..., None, :] & not_self

    wall_mask = state.wall_mask if plus else torch.zeros_like(state.wall_mask)
    ep1, ep2, emask = orca_ops.walls_to_edges(state.walls, wall_mask)

    pos = state.h_pos
    rad = state.h_radius + inflation
    v_pref = state.h_v_pref
    goal_vec = state.h_goal - pos
    speed = norm2(goal_vec)[..., None]
    if plus:
        # cap at v_pref - eps
        cap = (v_pref - 1e-3)[..., None]
        pref_vel = torch.where(speed > cap,
                               goal_vec / torch.clamp(speed, min=1e-9) * cap,
                               goal_vec)
    else:
        # unit cap
        pref_vel = torch.where(speed > 1.0,
                               goal_vec / torch.clamp(speed, min=1e-9),
                               goal_vec)

    def rows(x):
        # (*B, N, ...) -> (B x H, N, ...): every acting human's own copy
        x = x.unsqueeze(len(lead))
        return x.expand(*lead, H, *x.shape[len(lead) + 1:]).reshape(
            -1, *x.shape[len(lead) + 1:])

    def agents(x):
        return x.reshape(-1, *x.shape[len(lead) + 1:])

    out = orca_ops.orca_velocity(
        agents(pos), agents(state.h_vel), agents(rad), agents(pref_vel),
        agents(v_pref), rows(npos), rows(nvel), rows(nrad), agents(nmask),
        rows(ep1), rows(ep2), rows(emask), params,
        max_neighbors=cfg.orca_max_neighbors)
    return out.reshape(*lead, H, 2)


def _sfm_actions(state: SimState, cfg: EnvConfig) -> torch.Tensor:
    """Social Forces for all humans at once: the pull to the goal, the push
    of the other agents (the robot too when it is visible) and of every
    active wall, then a cap at v_pref. Walls with index 2 and up push with
    the bottleneck gains in the hallway bottleneck only."""
    H = cfg.max_humans
    lead = state.t.shape
    dev = state.h_pos.device
    pos, vel = state.h_pos, state.h_vel
    rad, v_pref = state.h_radius, state.h_v_pref

    # goal pull
    goal_vec = state.h_goal - pos
    dist_goal = norm2(goal_vec)
    dist_goal = torch.where(dist_goal < 1e-6, 1.0, dist_goal)
    desired_v = goal_vec / dist_goal[..., None] * v_pref[..., None]
    pull = cfg.sfm_KI * (desired_v - vel)

    # push from the other agents: humans, then the robot
    opos = torch.cat([pos, state.r_pos[..., None, :]], dim=-2)  # (.., H+1, 2)
    orad = torch.cat([rad, state.r_radius[..., None]], dim=-1)
    robot_vis = torch.full((*lead, 1), cfg.robot_visible, dtype=torch.bool,
                           device=dev)
    omask = torch.cat([state.h_mask, robot_vis], dim=-1)
    not_self = ~torch.eye(H, H + 1, dtype=torch.bool, device=dev)
    pair_mask = omask[..., None, :] & not_self              # (..., H, H+1)
    delta = pos[..., :, None, :] - opos[..., None, :, :]
    d = torch.clamp(norm2(delta), min=1e-9)
    # the policy's configured radius sets the asymmetric adjustment
    adjustment = (cfg.human_radius - orad).abs()[..., None, :] + 0.01
    mag = cfg.sfm_A * torch.exp(
        (rad[..., :, None] + orad[..., None, :] + adjustment - d) / cfg.sfm_B)
    push_agents = torch.where(pair_mask[..., None],
                              mag[..., None] * delta / d[..., None],
                              0.0).sum(dim=-2)

    # push from the walls, each at its point closest to the human
    walls = state.walls                                     # (..., W, 2, 2)
    W = walls.shape[-3]
    cp = closest_point_on_segment(walls[..., :, None, 0, :],
                                  walls[..., :, None, 1, :],
                                  pos[..., None, :, :])     # (..., W, H, 2)
    delta_w = pos[..., None, :, :] - cp
    d_w = torch.clamp(norm2(delta_w), min=1e-9)
    is_bneck = torch.arange(W, device=dev)[:, None] >= 2
    if cfg.scenario != "hallway_bottleneck":
        is_bneck = torch.zeros_like(is_bneck)
    A_w = torch.where(is_bneck, cfg.sfm_A_bottleneck, cfg.sfm_A_static)
    B_w = torch.where(is_bneck, cfg.sfm_B_bottleneck, cfg.sfm_B_static)
    mag_w = A_w * torch.exp((rad[..., None, :] + 0.01 - d_w) / B_w)
    push_walls = torch.where(state.wall_mask[..., :, None, None],
                             mag_w[..., None] * delta_w / d_w[..., None],
                             0.0).sum(dim=-3)

    new_v = vel + (pull + push_agents + push_walls) * cfg.dt
    speed = norm2(new_v)
    over = speed > v_pref
    return torch.where(over[..., None],
                       new_v / torch.clamp(speed, min=1e-9)[..., None] *
                       v_pref[..., None], new_v)


def _linear_actions(state: SimState, cfg: EnvConfig) -> torch.Tensor:
    """Straight to the goal at v_pref."""
    goal_vec = state.h_goal - state.h_pos
    theta = torch.atan2(goal_vec[..., 1], goal_vec[..., 0])
    return state.h_v_pref[..., None] * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=-1)


def human_actions(state: SimState, cfg: EnvConfig) -> torch.Tensor:
    """Dispatch on the configured human policy; returns (..., H, 2)
    ActionXY."""
    if cfg.human_policy == "orca":
        return _orca_actions(state, cfg, plus=False)
    if cfg.human_policy == "orca_plus":
        return _orca_actions(state, cfg, plus=True)
    if cfg.human_policy == "sfm":
        return _sfm_actions(state, cfg)
    if cfg.human_policy == "linear":
        return _linear_actions(state, cfg)
    raise ValueError(cfg.human_policy)

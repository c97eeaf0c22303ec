"""Human policies (twin of ``sicnav_tpu/env/human_policies.py``).

Maps the sim state to a (H, 2) tensor of holonomic velocity actions for
every human slot at once. ORCA and ORCA-plus are ported; Social Forces and
linear humans come with a later slice of the port.
"""

from __future__ import annotations

import torch

from sicnav_tpu_torch.env.types import EnvConfig, SimState
from sicnav_tpu_torch.ops import orca as orca_ops
from sicnav_tpu_torch.ops.geometry import norm2


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


def human_actions(state: SimState, cfg: EnvConfig) -> torch.Tensor:
    """Dispatch on the configured human policy; returns (..., H, 2)
    ActionXY."""
    if cfg.human_policy == "orca":
        return _orca_actions(state, cfg, plus=False)
    if cfg.human_policy == "orca_plus":
        return _orca_actions(state, cfg, plus=True)
    if cfg.human_policy in ("sfm", "linear"):
        raise NotImplementedError(
            f"human_policy={cfg.human_policy!r} is not ported yet; it comes "
            "with the slice that ports SFM and linear humans (ROADMAP.md, "
            "Queue 1 item 3)")
    raise ValueError(cfg.human_policy)

"""ORCA(-plus) as a robot policy (twin of
``sicnav_tpu/policies/orca_robot.py``): the batched ORCA kernel of the
humans acting on the robot slot.

A state with leading episode axes puts every episode's robot into one
``ops/orca.orca_velocity`` call, so the LP reads its fail flags on the host
once per step for the whole batch.
"""

from __future__ import annotations

import torch

from sicnav_tpu_torch.env.types import EnvConfig, SimState
from sicnav_tpu_torch.ops import orca as orca_ops
from sicnav_tpu_torch.ops.geometry import norm2


def orca_robot_action(state: SimState, cfg: EnvConfig, plus: bool = True,
                      safety_space: float = 0.01) -> torch.Tensor:
    """Holonomic (vx, vy) action for the robot via ORCA(-plus): (*B, 2)
    for the state's leading episode axes B (none for one episode)."""
    params = orca_ops.OrcaParams(
        neighbor_dist=cfg.orca_neighbor_dist,
        time_horizon=cfg.orca_time_horizon,
        time_horizon_obst=cfg.orca_time_horizon_obst,
        dt=cfg.dt)
    inflation = 0.01 + safety_space
    wall_mask = state.wall_mask if plus else torch.zeros_like(state.wall_mask)
    ep1, ep2, emask = orca_ops.walls_to_edges(state.walls, wall_mask)

    goal_vec = state.r_goal - state.r_pos
    speed = norm2(goal_vec)[..., None]
    if plus:
        cap = (state.r_v_pref - 1e-3)[..., None]
        pref_vel = torch.where(speed > cap,
                               goal_vec / torch.clamp(speed, min=1e-9) * cap,
                               goal_vec)
    else:
        pref_vel = torch.where(speed > 1.0,
                               goal_vec / torch.clamp(speed, min=1e-9),
                               goal_vec)

    lead = state.t.shape

    def flat(x):
        # (*B, ...) -> (prod B, ...): one LP row per episode's robot
        return x.reshape(-1, *x.shape[len(lead):])

    out = orca_ops.orca_velocity(
        flat(state.r_pos), flat(state.r_vel), flat(state.r_radius + inflation),
        flat(pref_vel), flat(state.r_v_pref), flat(state.h_pos),
        flat(state.h_vel), flat(state.h_radius + inflation),
        flat(state.h_mask), flat(ep1), flat(ep2), flat(emask), params,
        max_neighbors=cfg.orca_max_neighbors)
    return out.reshape(*lead, 2)

"""Observation-path state filter: a per-human constant-velocity Kalman
filter (twin of ``sicnav_tpu/utils/state_filter.py``).

The sim-side counterpart of the perception filtering upstream of a real
robot's ``select_action``: a steady-gain constant-velocity Kalman filter
applied to the human observations before the policy sees them. Per human
and per axis the state is [p, v] with F = [[1, dt], [0, 1]], white-accel
process noise Q(accel_std) and a full [p, v] measurement; every human and
axis shares one (R, Q), so one 2 x 2 covariance P drives them all.

With a leading episode axis (``init_filter(num_hums, batch=B)``) each
episode keeps its own P and its own first-call seeding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.env.types import SimState


@dataclasses.dataclass(frozen=True)
class KFConfig:
    dt: float = 0.25
    pos_std: float = 0.05    # assumed measurement noise (match NoiseConfig)
    vel_std: float = 0.05
    accel_std: float = 2.0   # process noise: how hard a human may maneuver


class KFState(NamedTuple):
    x: torch.Tensor            # (..., H, 4) filtered [px, py, vx, vy]
    P: torch.Tensor            # (..., 2, 2) shared per-axis [p, v] covariance
    initialized: torch.Tensor  # (...) bool: the first call seeds x


def init_filter(num_hums: int, batch: Optional[int] = None,
                device=None) -> KFState:
    """A filter that has seen nothing, on ``device`` (CUDA unless named);
    with ``batch`` one per episode on a leading axis."""
    device = resolve_device(device)
    lead = () if batch is None else (batch,)
    return KFState(
        x=torch.zeros(lead + (num_hums, 4), device=device),
        P=torch.eye(2, device=device).expand(lead + (2, 2)).clone(),
        initialized=torch.zeros(lead, dtype=torch.bool, device=device))


def _matrices(cfg: KFConfig, device=None):
    dt = cfg.dt
    F = torch.tensor([[1.0, dt], [0.0, 1.0]], device=device)
    q = cfg.accel_std ** 2
    Q = q * torch.tensor([[dt ** 4 / 4.0, dt ** 3 / 2.0],
                          [dt ** 3 / 2.0, dt ** 2]], device=device)
    R = torch.diag(torch.tensor([cfg.pos_std ** 2, cfg.vel_std ** 2],
                                device=device))
    return F, Q, R


def kf_step(obs_pos, obs_vel, kf: KFState, cfg: KFConfig):
    """One predict + update on the (..., H, 2) position and velocity
    observations. Returns (pos_f, vel_f, kf')."""
    F, Q, R = _matrices(cfg, obs_pos.device)
    p_prev = kf.x[..., 0:2]
    v_prev = kf.x[..., 2:4]
    # predict
    p_pred = p_prev + v_prev * cfg.dt
    v_pred = v_prev
    P_pred = F @ kf.P @ F.T + Q
    # update: z = [p, v], H = I, so K = P_pred (P_pred + R)^-1
    K = torch.linalg.solve((P_pred + R).mT, P_pred.mT).mT   # (..., 2, 2)
    k = K[..., None, None, :, :]                            # over (H, 2)
    y_p = obs_pos - p_pred
    y_v = obs_vel - v_pred
    p_new = p_pred + k[..., 0, 0] * y_p + k[..., 0, 1] * y_v
    v_new = v_pred + k[..., 1, 0] * y_p + k[..., 1, 1] * y_v
    P_new = (torch.eye(2, device=obs_pos.device) - K) @ P_pred
    # the first observation seeds the state (no prior to predict from)
    init = kf.initialized[..., None, None]
    p_out = torch.where(init, p_new, obs_pos)
    v_out = torch.where(init, v_new, obs_vel)
    P_out = torch.where(init, P_new, R)
    return p_out, v_out, KFState(x=torch.cat([p_out, v_out], dim=-1),
                                 P=P_out,
                                 initialized=torch.ones_like(kf.initialized))


def filter_observation(state: SimState, kf: KFState, cfg: KFConfig):
    """Returns (the state with filtered human pos / vel, kf')."""
    pos_f, vel_f, kf2 = kf_step(state.h_pos, state.h_vel, kf, cfg)
    return state._replace(h_pos=pos_f, h_vel=vel_f), kf2


def filtered_policy_stateful(step_fn, cfg: KFConfig):
    """Wrap a stateful policy ``step_fn(state, carry) -> (action, carry,
    ...)`` so that it observes Kalman-filtered human states. The wrapped
    carry is ``(KFState, inner_carry)``. Compose it inside the noise
    wrapper (noise first, then the filter, then the policy):

        policy = noisy_policy_stateful(
            filtered_policy_stateful(step_fn, kf_cfg), noise_cfg)
    """
    def wrapped(state: SimState, carry):
        kf, inner = carry
        st_f, kf2 = filter_observation(state, kf, cfg)
        out = step_fn(st_f, inner)
        return (out[0], (kf2, out[1])) + tuple(out[2:])
    return wrapped

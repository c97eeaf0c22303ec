"""Prediction baselines (twin of ``sicnav_tpu/diffusion/baselines.py``):
standing, constant velocity, and constant velocity with an iterative
pairwise collision fix, over (H, 2) agents (any leading axes)."""

from __future__ import annotations

import torch


def standing_forecast(pos, horizon: int):
    """(..., H, 2) current positions -> (..., H, T, 2): agents stay put."""
    return pos[..., None, :].expand(*pos.shape[:-1], horizon, 2)


def constant_velocity_forecast(pos, vel, dt: float, horizon: int):
    """(..., H, 2) positions and velocities -> (..., H, T, 2)."""
    steps = (torch.arange(horizon, device=pos.device) + 1)[:, None] * dt
    return pos[..., None, :] + vel[..., None, :] * steps


def cv_collision_fixed_forecast(pos, vel, radius, mask, dt: float,
                                horizon: int, fix_iters: int = 5,
                                margin: float = 0.02):
    """CV forecast with iterative pairwise collision resolution: at each
    future step every overlapping pair of valid agents is pushed apart
    symmetrically along its separation until (combined radius + margin)
    apart, ``fix_iters`` times per step, step after step so the fixes
    propagate.

    pos, vel (..., H, 2); radius, mask (..., H). Returns (..., H, T, 2)."""
    H = pos.shape[-2]
    eye = torch.eye(H, dtype=torch.bool, device=pos.device)
    comb = radius[..., :, None] + radius[..., None, :] + margin
    pair_ok = mask[..., :, None] & mask[..., None, :] & ~eye
    traj = []
    p = pos
    for _ in range(horizon):
        p = p + vel * dt
        for _ in range(fix_iters):
            d = p[..., :, None, :] - p[..., None, :, :]           # (..., H, H, 2)
            dist = torch.sqrt(torch.clamp((d * d).sum(dim=-1), min=1e-12))
            overlap = torch.where(pair_ok, torch.clamp(comb - dist, min=0.0),
                                  torch.zeros_like(dist))
            push = 0.5 * overlap[..., None] * d / dist[..., None]
            p = p + push.sum(dim=-2)
        traj.append(p)
    return torch.stack(traj, dim=-2)

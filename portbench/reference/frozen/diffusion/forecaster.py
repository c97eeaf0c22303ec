"""Human trajectory forecaster for the closed control loop (twin of
``sicnav_tpu/diffusion/forecaster.py``).

A per-human position-history ring buffer, scene construction around the
robot with attention-radius clustering (agents outside the cluster get
constant-velocity forecasts), batched diffusion sampling and KDE top-k
ranking.

Every function takes leading episode axes on its state and sim state: the
B episodes' scenes go through the encoder and every denoiser pass as one
batch (each scene attends only within itself), and their joint KDE
rankings go to the kernel as one call of B x horizon groups.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.frozen.device import resolve_device
from portbench.reference.frozen.diffusion import kde
from portbench.reference.frozen.diffusion.data import ATTENTION_RADIUS, SceneBatch
from portbench.reference.frozen.diffusion.mid import JMIDModel
from portbench.reference.frozen.env.types import SimState


@dataclasses.dataclass(frozen=True)
class ForecasterConfig:
    """The reference's forecaster configuration, field for field."""
    past_frames: int = 6
    horizon: int = 8
    num_samples: int = 100
    num_ret_samples: int = 10
    # DDIM stride over the 100-step schedule; NFE per forecast = 100 / stride
    ddim_stride: int = 2
    dt: float = 0.25
    joint: bool = True
    cluster_radius: float = ATTENTION_RADIUS


class ForecasterState(NamedTuple):
    hist: torch.Tensor       # (..., H, T_h, 2) position history (old -> new)
    count: torch.Tensor      # (..., H) valid frames per human


def init_state(max_humans: int, cfg: ForecasterConfig,
               device=None) -> ForecasterState:
    """Empty history on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    return ForecasterState(
        hist=torch.zeros((max_humans, cfg.past_frames, 2), dtype=torch.float32,
                         device=device),
        count=torch.zeros((max_humans,), dtype=torch.int32, device=device))


def update_state_hists(fstate: ForecasterState, sim: SimState,
                       cfg: ForecasterConfig) -> ForecasterState:
    """Push the current human positions."""
    hist = torch.cat([fstate.hist[..., 1:, :], sim.h_pos[..., None, :]],
                     dim=-2)
    count = torch.clamp(fstate.count + 1, max=cfg.past_frames)
    return ForecasterState(hist=hist, count=count)


def _scene_batch_from_hist(fstate: ForecasterState, sim: SimState,
                           cfg: ForecasterConfig) -> SceneBatch:
    """Histories -> SceneBatch (finite-difference vel/acc, masks)."""
    T = cfg.past_frames
    pos = fstate.hist                                   # (..., H, T, 2)
    dvel = torch.diff(pos, dim=-2) / cfg.dt
    vel = torch.cat([dvel[..., :1, :], dvel], dim=-2)
    dacc = torch.diff(vel, dim=-2) / cfg.dt
    acc = torch.cat([dacc[..., :1, :], dacc], dim=-2)
    hist = torch.cat([pos, vel, acc], dim=-1)

    frame_idx = torch.arange(T, device=pos.device)
    hist_mask = frame_idx >= (T - fstate.count[..., None])
    agent_mask = sim.h_mask & (fstate.count > 0)

    cur = sim.h_pos
    *lead, H, _ = cur.shape
    d = torch.linalg.norm(cur[..., :, None, :] - cur[..., None, :, :], dim=-1)
    eye = torch.eye(H, dtype=torch.bool, device=cur.device)
    neighbor_mask = (d < ATTENTION_RADIUS) & agent_mask[..., :, None] & \
        agent_mask[..., None, :] & ~eye

    F = cfg.horizon
    return SceneBatch(
        hist=torch.where(hist_mask[..., None], hist, torch.zeros_like(hist)),
        hist_mask=hist_mask,
        fut_vel=torch.zeros((*lead, H, F, 2), dtype=torch.float32,
                            device=cur.device),
        fut_mask=torch.zeros((*lead, H, F), dtype=torch.bool,
                             device=cur.device),
        agent_mask=agent_mask,
        neighbor_mask=neighbor_mask)


def cvmm_forecast(sim: SimState, cfg: ForecasterConfig):
    """Constant-velocity forecast: (..., H, T_f, 2)."""
    steps = (torch.arange(cfg.horizon, device=sim.h_pos.device) + 1
             )[:, None] * cfg.dt
    return sim.h_pos[..., None, :] + sim.h_vel[..., None, :] * steps


def predict_ret_best(model: JMIDModel, fstate: ForecasterState, sim: SimState,
                     cfg: ForecasterConfig, generator=None, x_T=None):
    """Forecast + rank. Returns (forecasts (..., H, k, horizon+1, 2) with
    the current pose prepended, log_weights (..., H, k)), for the leading
    episode axes of ``fstate`` and ``sim`` (none for one episode).

    The start noise is drawn with ``generator`` (a torch.Generator on the
    model's device; for a batch of episodes a sequence of them, one per
    episode, so that each episode's forecast is the one it would get
    alone) unless ``x_T`` (..., num_samples*H, horizon, 2) is given.
    """
    batch = _scene_batch_from_hist(fstate, sim, cfg)

    # cluster around the robot: humans beyond the radius get CV forecasts
    dist_to_rob = torch.linalg.norm(sim.h_pos - sim.r_pos[..., None, :],
                                    dim=-1)
    in_cluster = batch.agent_mask & (dist_to_rob < cfg.cluster_radius)
    batch = batch._replace(agent_mask=in_cluster,
                           neighbor_mask=batch.neighbor_mask &
                           in_cluster[..., :, None] & in_cluster[..., None, :])

    samples = model.sample(batch, cfg.num_samples, generator=generator,
                           x_T=x_T, stride=cfg.ddim_stride)  # (.., S, H, T_f, 2)

    cv = cvmm_forecast(sim, cfg)
    samples = torch.where(in_cluster[..., None, :, None, None], samples,
                          cv[..., None, :, :, :])

    top, log_w = kde.most_likely_samples(samples, cfg.num_ret_samples,
                                         joint=cfg.joint)
    # prepend the current pose
    k = cfg.num_ret_samples
    cur = sim.h_pos[..., :, None, None, :].expand(*top.shape[:-3], k, 1, 2)
    return torch.cat([cur, top], dim=-2), log_w

"""JMID model wrapper (twin of ``sicnav_tpu/diffusion/mid.py``): encoder +
denoiser for one scene, with encode / denoise / sample. Training comes with
a later slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion import diffusion as DF
from sicnav_tpu_torch.diffusion.data import SceneBatch
from sicnav_tpu_torch.diffusion.models import (
    ModelConfig, TrajectronEncoder, integrate_velocity_samples, make_denoiser,
    standardize_history,
)


class JMIDModel(nn.Module):
    """Encoder + denoiser; one scene (A agents) per call, or one per
    episode when the ``SceneBatch`` has leading episode axes B. The module
    lives on ``device`` (CUDA unless named) in eval mode."""

    def __init__(self, cfg: ModelConfig, joint: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = TrajectronEncoder(cfg)
        self.denoiser, self.denoiser_joint = make_denoiser(cfg, joint)
        self.sched = DF.make_schedule(100, device=device)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def encode(self, batch: SceneBatch):
        """Per-agent context vectors (*B, A, 2*enc_rnn_dim)."""
        *lead, A, T, D = batch.hist.shape
        cur_pos = batch.hist[..., -1, 0:2]
        hist_st = standardize_history(batch.hist, cur_pos)
        # neighbour histories standardized relative to the TARGET's position
        neigh = batch.hist.unsqueeze(-4).expand(*lead, A, A, T, D)
        target_pos = cur_pos[..., :, None, :].expand(*lead, A, A, 2)
        neigh_st = standardize_history(neigh, target_pos)
        return self.encoder(hist_st, batch.hist_mask, neigh_st,
                            batch.neighbor_mask)

    def scene_attn_mask(self, batch: SceneBatch):
        """(*B, A*T, A*T) attention mask: tokens attend within the scene's
        valid agents (block-diagonal over agents)."""
        *lead, A = batch.agent_mask.shape
        T = self.cfg.horizon
        ok = batch.agent_mask
        m = ok[..., :, None] & ok[..., None, :]                 # (*B, A, A)
        return m[..., :, None, :, None].expand(*lead, A, T, A, T).reshape(
            *lead, A * T, A * T)

    @torch.no_grad()
    def denoise(self, x, beta, context, batch: SceneBatch, scene_mask=None):
        """x (*B, S, A, T, 2); beta (*B, S, A); context (*B, S, A, F) ->
        eps (*B, S, A, T, 2)."""
        if scene_mask is None:
            scene_mask = self.scene_attn_mask(batch)
        return self.denoiser(x, beta, context, scene_mask)

    @torch.no_grad()
    def sample(self, batch: SceneBatch, n_samples: int, generator=None,
               x_T=None, stride: int = 2, dt: float = 0.25):
        """Forecast positions (*B, n_samples, A, T, 2). ``x_T``
        (*B, n_samples*A, T, 2) replaces the start noise drawn from
        ``generator`` (with B episode axes, one generator per episode, see
        ``diffusion.sample``)."""
        context = self.encode(batch)
        *lead, A = batch.agent_mask.shape
        scene_mask = self.scene_attn_mask(batch)

        def net(x, beta, ctx):
            S = x.shape[-3] // A
            out = self.denoise(x.reshape(*lead, S, A, *x.shape[-2:]),
                               beta.reshape(*lead, S, A),
                               ctx.reshape(*lead, S, A, -1), batch,
                               scene_mask)
            return out.reshape(x.shape)

        vel = DF.sample(net, self.sched, n_samples, context, self.cfg.horizon,
                        stride=stride, generator=generator, x_T=x_T)
        p0 = batch.hist[..., -1, 0:2]
        return integrate_velocity_samples(vel, p0[..., None, :, :], dt)

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
    """Encoder + denoiser; one scene (A agents) per call. The module lives on
    ``device`` (CUDA unless named) in eval mode."""

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
        """Per-agent context vectors (A, 2*enc_rnn_dim)."""
        A = batch.hist.shape[0]
        cur_pos = batch.hist[:, -1, 0:2]
        hist_st = standardize_history(batch.hist, cur_pos)
        # neighbour histories standardized relative to the TARGET's position
        neigh = batch.hist[None].expand(A, *batch.hist.shape)
        target_pos = cur_pos[:, None, :].expand(A, A, 2)
        neigh_st = standardize_history(neigh, target_pos)
        return self.encoder(hist_st, batch.hist_mask, neigh_st,
                            batch.neighbor_mask)

    def scene_attn_mask(self, batch: SceneBatch):
        """(A*T, A*T) attention mask: tokens attend within the scene's valid
        agents (block-diagonal over agents)."""
        A = batch.agent_mask.shape[0]
        T = self.cfg.horizon
        ok = batch.agent_mask
        m = ok[:, None] & ok[None, :]                           # (A, A)
        return m[:, None, :, None].expand(A, T, A, T).reshape(A * T, A * T)

    @torch.no_grad()
    def denoise(self, x, beta, context, batch: SceneBatch, scene_mask=None):
        """x (S, A, T, 2); beta (S, A); context (S, A, F) -> eps (S, A, T, 2)."""
        if scene_mask is None:
            scene_mask = self.scene_attn_mask(batch)
        return self.denoiser(x, beta, context, scene_mask)

    @torch.no_grad()
    def sample(self, batch: SceneBatch, n_samples: int, generator=None,
               x_T=None, stride: int = 2, dt: float = 0.25):
        """Forecast positions (n_samples, A, T, 2). ``x_T`` (n_samples*A, T, 2)
        replaces the start noise drawn from ``generator``."""
        context = self.encode(batch)
        A = batch.agent_mask.shape[0]
        scene_mask = self.scene_attn_mask(batch)

        def net(x, beta, ctx):
            S = x.shape[0] // A
            out = self.denoise(x.reshape(S, A, *x.shape[1:]),
                               beta.reshape(S, A), ctx.reshape(S, A, -1),
                               batch, scene_mask)
            return out.reshape(x.shape)

        vel = DF.sample(net, self.sched, n_samples, context, self.cfg.horizon,
                        stride=stride, generator=generator, x_T=x_T)
        p0 = batch.hist[:, -1, 0:2]
        return integrate_velocity_samples(vel, p0[None], dt)

"""JMID / iMID model wrapper and training loop (twin of
``sicnav_tpu/diffusion/mid.py``): an encoder + denoiser pair (any of
``models.DIFFNETS``; the encoder class-conditioned with ``num_node_types
> 1``) with encode / denoise / sample for inference, the epsilon-MSE
training loss with joint-scene attention masks and masked agents, Adam with a staircase
per-epoch learning-rate decay and global-norm clipping, early stopping on
validation ADE, the full metric sweep and ``.npz`` checkpoints.

The reference trains one scene per call and ``vmap``s over a batch of
scenes; here a ``SceneBatch`` with a leading scene axis goes through the
encoder and the denoiser as one batch, and the loss keeps one masked mean
per scene before the mean over scenes, as the reference's does. Inference
(``encode``, ``denoise``, ``sample``) runs without gradients and without
dropout in either mode; the training loss (``forward``) runs with
gradients, and with dropout in ``train()`` mode.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from portbench.reference.frozen.device import resolve_device
from portbench.reference.frozen.diffusion import diffusion as DF
from portbench.reference.frozen.diffusion.data import SceneBatch
from portbench.reference.frozen.diffusion.models import (
    ModelConfig, TrajectronEncoder, init_parameters,
    integrate_velocity_samples, make_denoiser, standardize_history,
)

# the reference's integration step for ground-truth futures (mid.py)
GT_DT = 0.25


def _inference(fn):
    """Run ``fn`` without gradients and with dropout off, whatever mode
    the module is in; the mode is restored after."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        was_training = self.training
        self.train(False)
        try:
            with torch.no_grad():
                return fn(self, *args, **kwargs)
        finally:
            self.train(was_training)
    return wrapped


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training configuration, field for field (defaults
    = configs/ddim_jp_sim.yaml)."""
    joint: bool = True             # JMID vs iMID
    lr: float = 1e-4
    lr_decay: float = 0.98         # ExponentialLR gamma, once per epoch
    epochs: int = 90
    batch_size: int = 8            # scenes per step
    grad_clip: float = 1.0
    num_diffusion_steps: int = 100
    early_stop_patience: int = 10
    eval_samples: int = 20
    eval_stride: int = 2
    seed: int = 0


class JMIDModel(nn.Module):
    """Encoder + denoiser; one scene (A agents) per call, or one per
    leading index when the ``SceneBatch`` has leading scene or episode
    axes B. The module lives on ``device`` (CUDA unless named) in eval
    mode."""

    def __init__(self, cfg: ModelConfig, joint: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = TrajectronEncoder(cfg)
        self.denoiser, self.denoiser_joint = make_denoiser(cfg, joint)
        self.sched = DF.make_schedule(100, device=device)
        self.to(device)
        self.eval()

    def _encode(self, batch: SceneBatch, generator=None):
        *lead, A, T, D = batch.hist.shape
        cur_pos = batch.hist[..., -1, 0:2]
        hist_st = standardize_history(batch.hist, cur_pos)
        # neighbour histories standardized relative to the TARGET's position
        neigh = batch.hist.unsqueeze(-4).expand(*lead, A, A, T, D)
        target_pos = cur_pos[..., :, None, :].expand(*lead, A, A, 2)
        neigh_st = standardize_history(neigh, target_pos)
        types = neigh_types = None
        if self.cfg.num_node_types > 1:
            # each agent is routed by its class; neighbour slot a carries
            # agent a's class
            types = torch.as_tensor(batch.types(), device=batch.hist.device)
            neigh_types = types[..., None, :].expand(*lead, A, A)
        return self.encoder(hist_st, batch.hist_mask, neigh_st,
                            batch.neighbor_mask, generator, types,
                            neigh_types)

    @_inference
    def encode(self, batch: SceneBatch):
        """Per-agent context vectors (*B, A, 2*enc_rnn_dim)."""
        return self._encode(batch)

    def scene_attn_mask(self, batch: SceneBatch):
        """(*B, A*T, A*T) attention mask: tokens attend within the scene's
        valid agents (block-diagonal over agents)."""
        *lead, A = batch.agent_mask.shape
        T = self.cfg.horizon
        ok = batch.agent_mask
        m = ok[..., :, None] & ok[..., None, :]                 # (*B, A, A)
        return m[..., :, None, :, None].expand(*lead, A, T, A, T).reshape(
            *lead, A * T, A * T)

    def _denoise(self, x, beta, context, batch: SceneBatch, scene_mask=None,
                 generator=None):
        if not self.denoiser_joint:
            return self.denoiser(x, beta, context, generator)
        if scene_mask is None:
            scene_mask = self.scene_attn_mask(batch)
        return self.denoiser(x, beta, context, scene_mask, generator)

    @_inference
    def denoise(self, x, beta, context, batch: SceneBatch, scene_mask=None):
        """x (*B, S, A, T, 2); beta (*B, S, A); context (*B, S, A, F) ->
        eps (*B, S, A, T, 2). A joint denoiser sees each sample's scene; a
        non-joint one each agent's sequence alone."""
        return self._denoise(x, beta, context, batch, scene_mask)

    def forward(self, batch: SceneBatch, generator=None, t=None, eps=None):
        """Training loss of each scene (*B): the masked epsilon MSE over the
        scene's present agents and observed future steps. The diffusion
        steps t (*B, A), the noise eps (*B, A, T, 2) and, in train mode,
        the dropout masks are drawn from ``generator`` (t and eps unless
        given)."""
        context = self._encode(batch, generator)
        loss_mask = ~(batch.fut_mask & batch.agent_mask[..., None])
        if self.denoiser_joint:
            scene_mask = self.scene_attn_mask(batch)

            def net(x, beta, ctx):
                # one sample per scene: the denoiser's sample axis
                return self._denoise(x.unsqueeze(-4), beta.unsqueeze(-2),
                                     ctx.unsqueeze(-3), batch, scene_mask,
                                     generator).squeeze(-4)
        else:
            def net(x, beta, ctx):
                return self.denoiser(x, beta, ctx, generator)

        return DF.diffusion_loss(net, self.sched, batch.fut_vel, context,
                                 loss_mask, generator, t, eps)

    @_inference
    def sample(self, batch: SceneBatch, n_samples: int, generator=None,
               x_T=None, stride: int = 2, dt: float = 0.25,
               sampling: str = "ddim", noise=None):
        """Forecast positions (*B, n_samples, A, T, 2). ``x_T``
        (*B, n_samples*A, T, 2) replaces the start noise and ``noise`` the
        DDPM steps' draws (see ``diffusion.sample``), otherwise drawn from
        ``generator`` (with B episode axes, one generator per episode). A
        joint denoiser sees each sample's scene; a non-joint one takes the
        (n_samples*A) sequences, sample major, as one batch."""
        context = self._encode(batch)
        *lead, A = batch.agent_mask.shape
        if self.denoiser_joint:
            scene_mask = self.scene_attn_mask(batch)

            def net(x, beta, ctx):
                S = x.shape[-3] // A
                out = self._denoise(x.reshape(*lead, S, A, *x.shape[-2:]),
                                    beta.reshape(*lead, S, A),
                                    ctx.reshape(*lead, S, A, -1), batch,
                                    scene_mask)
                return out.reshape(x.shape)
        else:
            net = self.denoiser

        vel = DF.sample(net, self.sched, n_samples, context, self.cfg.horizon,
                        sampling=sampling, stride=stride,
                        generator=generator, x_T=x_T, noise=noise)
        p0 = batch.hist[..., -1, 0:2]
        return integrate_velocity_samples(vel, p0[..., None, :, :], dt)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip: float


def make_train_state(model: JMIDModel, tc: TrainConfig, steps_per_epoch: int,
                     init: bool = True) -> TrainState:
    """Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8) at ``tc.lr``,
    decayed by ``tc.lr_decay`` once every ``steps_per_epoch`` updates (a
    staircase), after a global-norm clip at ``tc.grad_clip``. With
    ``init`` the parameters are first drawn anew with Flax's initializers
    from ``tc.seed``, as the reference's ``model.init`` draws them."""
    if init:
        init_parameters(model, torch.Generator().manual_seed(tc.seed))
    opt = torch.optim.Adam(model.parameters(), lr=tc.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    spe = max(int(steps_per_epoch), 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: tc.lr_decay ** (step // spe))
    return TrainState(opt, sched, tc.grad_clip)


def clip_by_global_norm_(params, max_norm: float):
    """optax's ``clip_by_global_norm`` in place: every gradient times
    max_norm / ||g|| when the global norm ||g|| reaches max_norm, else
    unchanged (no epsilon is added to the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm; no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def train_step(model: JMIDModel, state: TrainState, batch: SceneBatch,
               generator=None, t=None, eps=None, mesh=None):
    """One update over a batch with a leading scene axis: the mean over
    scenes of each scene's loss, its gradients clipped, one Adam step and
    one step of the learning-rate schedule. Runs in train mode (dropout
    on) and leaves the model in the mode it found it. Returns the loss, a
    0-d tensor on the device (not synchronized).

    With ``mesh`` (``parallel.mesh.Mesh``) each rank holds an equal share of
    the scenes and the same parameters: the gradients and the loss are
    averaged over the ranks before the clip."""
    was_training = model.training
    model.train()
    try:
        state.optimizer.zero_grad(set_to_none=True)
        loss = model(batch, generator, t, eps).mean()
        loss.backward()
        if mesh is not None:
            raise ValueError("the frozen reference trains on one device")
        clip_by_global_norm_(model.parameters(), state.grad_clip)
        state.optimizer.step()
        state.scheduler.step()
    finally:
        model.train(was_training)
    return loss.detach()

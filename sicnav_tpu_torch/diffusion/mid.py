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

from sicnav_tpu_torch import convert
from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion import diffusion as DF
from sicnav_tpu_torch.diffusion import evaluation as EV
from sicnav_tpu_torch.diffusion.data import SceneBatch
from sicnav_tpu_torch.diffusion.models import (
    ModelConfig, TrajectronEncoder, init_parameters,
    integrate_velocity_samples, make_denoiser, standardize_history,
)
from sicnav_tpu_torch.parallel.mesh import all_mean, all_mean_grads

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
            all_mean_grads(model.parameters(), mesh)
            loss = all_mean(loss, mesh)
        clip_by_global_norm_(model.parameters(), state.grad_clip)
        state.optimizer.step()
        state.scheduler.step()
    finally:
        model.train(was_training)
    return loss.detach()


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _scene_samples(model: JMIDModel, batch: SceneBatch, n_samples, generator,
                   x_T, stride):
    """Samples (*B, S, A, T, 2) and ground truth (*B, A, T, 2). Every scene
    of a batch starts from the same noise, drawn once: the reference
    ``vmap``s its evaluation over the scenes with one key."""
    *lead, A = batch.agent_mask.shape
    T = model.cfg.horizon
    if x_T is None:
        x_T = torch.randn((n_samples * A, T, 2), generator=generator,
                          device=batch.hist.device)
    x_T = x_T.expand(*lead, n_samples * A, T, 2)
    pred = model.sample(batch, n_samples, x_T=x_T, stride=stride)
    p0 = batch.hist[..., -1, 0:2]
    gt = integrate_velocity_samples(batch.fut_vel, p0, GT_DT)
    return pred, gt


def _per_agent(pred):
    """(*B, S, A, T, 2) -> (*B, A, S, T, 2): each agent's samples."""
    return pred.movedim(-4, -3)


def _valid_agents(batch: SceneBatch):
    """Agents present now with any observed future step, as float weights,
    and their count clamped at 1."""
    amask = batch.agent_mask & batch.fut_mask.any(dim=-1)
    w = amask.to(torch.float32)
    return amask, w, torch.clamp(w.sum(dim=-1), min=1.0)


@torch.no_grad()
def eval_scene(model: JMIDModel, batch: SceneBatch, n_samples: int = 20,
               generator=None, x_T=None, stride: int = 2):
    """Min-of-k ADE / FDE over the scene's valid agents and the scene's
    SADE / SFDE: (ade, fde, sade, sfde), (*B) each. Partially observed
    futures are masked per step, not dropped: an agent counts if it has
    any observed future step. ``x_T`` (n_samples*A, T, 2) replaces the
    start noise drawn from ``generator``."""
    pred, gt = _scene_samples(model, batch, n_samples, generator, x_T, stride)
    amask, w, wsum = _valid_agents(batch)
    ades, fdes = EV.min_ade_fde(_per_agent(pred), gt, batch.fut_mask)
    sade, sfde = EV.scene_ade_fde(pred, gt, amask, batch.fut_mask)
    return ((ades * w).sum(dim=-1) / wsum, (fdes * w).sum(dim=-1) / wsum,
            sade, sfde)


@torch.no_grad()
def eval_scene_per_agent(model: JMIDModel, batch: SceneBatch,
                         n_samples: int = 20, generator=None, x_T=None,
                         stride: int = 2):
    """Per-agent min-of-k (ade (*B, A), fde (*B, A), valid (*B, A))."""
    pred, gt = _scene_samples(model, batch, n_samples, generator, x_T, stride)
    amask, _, _ = _valid_agents(batch)
    ades, fdes = EV.min_ade_fde(_per_agent(pred), gt, batch.fut_mask)
    return ades, fdes, amask


@torch.no_grad()
def eval_scene_full(model: JMIDModel, batch: SceneBatch, n_samples: int = 20,
                    generator=None, x_T=None, stride: int = 2):
    """The full metric sweep: min-of-k ADE / FDE, SADE / SFDE, most-likely
    ADE / FDE (the KDE ranking, on the hand-written kernel for CUDA
    tensors), KDE-NLL and the ADE at a quarter, half and three quarters of
    the horizon. A dict of (*B) tensors.

    The most-likely sample is ranked jointly over the scene's agents (G =
    T groups of dimension 2A), for every model, as the reference ranks it.
    For a non-joint, iMID model the dict also holds ``ml_ade_per_agent`` / ``ml_fde_per_agent``: each agent's
    own most likely sample, ``evaluation.most_likely_ade_fde(joint=False)``
    (A * T groups of dimension 2, a second kernel launch)."""
    pred, gt = _scene_samples(model, batch, n_samples, generator, x_T, stride)
    amask, w, wsum = _valid_agents(batch)
    m = batch.fut_mask
    per = _per_agent(pred)
    a_min, f_min = EV.min_ade_fde(per, gt, m)
    fr1, fr2, fr3 = EV.horizon_fraction_ade(per, gt, m)
    nll = EV.kde_nll(per, gt)
    sade, sfde = EV.scene_ade_fde(pred, gt, amask, m)
    ml_ade, ml_fde = EV.most_likely_ade_fde(pred, gt, agent_mask=amask,
                                            step_mask=m)

    def avg(x):
        return (x * w).sum(dim=-1) / wsum

    out = {
        "ade": avg(a_min), "fde": avg(f_min),
        "sade": sade, "sfde": sfde,
        "ml_ade": ml_ade, "ml_fde": ml_fde,
        "kde_nll": avg(nll),
        "ade_one_fourth": avg(fr1), "ade_two_fourth": avg(fr2),
        "ade_three_fourth": avg(fr3),
    }
    if not model.denoiser_joint:
        out["ml_ade_per_agent"], out["ml_fde_per_agent"] = \
            EV.most_likely_ade_fde(pred, gt, agent_mask=amask, step_mask=m,
                                   joint=False)
    return out


# ---------------------------------------------------------------------------
# the training loop and checkpoints
# ---------------------------------------------------------------------------

def fit(model: JMIDModel, train_batches, val_batches, tc: TrainConfig,
        checkpoint_path: Optional[str] = None, log_dir: Optional[str] = None,
        tensorboard: bool = False):
    """Training with early stopping. ``train_batches`` and ``val_batches``
    are lists of stacked ``SceneBatch`` (numpy or tensors; a leading scene
    axis), moved to the model's device once. Parameters are drawn anew
    from ``tc.seed``; the steps' noise, dropout and validation noise come
    from a generator seeded ``tc.seed + 1``. After each epoch the val ADE
    (mean over batches of the scenes' mean min-of-k ADE) decides: an
    improvement keeps the parameters and writes ``checkpoint_path`` (an
    ``.npz``), and ``tc.early_stop_patience`` epochs without one stop the
    run. ``log_dir`` streams the per-epoch loss and val ADE as JSONL.

    The model ends holding the best parameters. Returns (their
    state_dict, history: per epoch its loss, val ADE and wall seconds)."""
    logger = None
    if log_dir is not None:
        from sicnav_tpu_torch.utils.metrics import MetricsLogger
        logger = MetricsLogger(log_dir, "jmid", tensorboard=tensorboard)
    device = next(model.parameters()).device
    train_batches = [b.to_tensors(device) for b in train_batches]
    val_batches = [b.to_tensors(device) for b in val_batches]
    state = make_train_state(model, tc, max(len(train_batches), 1))
    gen = torch.Generator(device=device).manual_seed(tc.seed + 1)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_ade = np.inf
    best = snapshot()
    patience = 0
    history = []
    for epoch in range(tc.epochs):
        t0 = time.perf_counter()
        losses = [train_step(model, state, batch, gen)
                  for batch in train_batches]
        ep_loss = (float(torch.stack(losses).double().mean()) if losses
                   else np.nan)
        ades = [float(eval_scene(model, batch, tc.eval_samples, gen,
                                 stride=tc.eval_stride)[0].mean())
                for batch in val_batches]
        val_ade = float(np.mean(ades)) if ades else np.inf
        history.append({"epoch": epoch, "loss": ep_loss, "val_ade": val_ade,
                        "seconds": time.perf_counter() - t0})
        if logger is not None:
            logger.log(epoch, loss=ep_loss, val_ade=val_ade)
        if val_ade < best_ade:
            best_ade = val_ade
            best = snapshot()
            patience = 0
            # the best so far is on disk after every improvement, so a run
            # cut short still leaves a valid checkpoint
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, best)
        else:
            patience += 1
            if patience >= tc.early_stop_patience:
                break
    model.load_state_dict(best)
    if checkpoint_path is not None:
        save_checkpoint(checkpoint_path, best)
    if logger is not None:
        logger.close()
    return best, history


def save_checkpoint(path, state_dict):
    """A state_dict as an ``.npz`` in the layout ``convert.load_npz``
    reads (so ``sicnav_diffusion.make_policy`` serves it as it is)."""
    convert.save_npz(path, state_dict)


def load_checkpoint(path):
    """The state_dict of an ``.npz`` checkpoint (CPU tensors)."""
    return convert.load_npz(path)

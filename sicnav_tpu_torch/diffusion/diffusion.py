"""Diffusion core: variance schedules, the epsilon loss and the DDPM /
DDIM samplers (twin of ``sicnav_tpu/diffusion/diffusion.py``).

All samples x agents are denoised as one batch; the reverse loop over t is
a host loop. The schedule is computed in float64 with numpy and stored as
float32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from sicnav_tpu_torch.utils import tracing


class VarianceSchedule(NamedTuple):
    betas: torch.Tensor        # (T+1,) padded with beta_0 = 0
    alphas: torch.Tensor
    alpha_bars: torch.Tensor
    sigmas_flex: torch.Tensor
    sigmas_inflex: torch.Tensor
    num_steps: int


def make_schedule(num_steps: int = 100, mode: str = "linear",
                  beta_1: float = 1e-4, beta_T: float = 5e-2,
                  cosine_s: float = 8e-3, device=None) -> VarianceSchedule:
    """The reference's schedule on ``device``: betas linear from beta_1 to
    beta_T, or the cosine schedule (offset cosine_s, betas clipped at
    0.999); beta_0 = 0 in front."""
    if mode == "linear":
        betas = np.linspace(beta_1, beta_T, num_steps)
    elif mode == "cosine":
        ts = np.arange(num_steps + 1) / num_steps + cosine_s
        al = np.cos(ts / (1 + cosine_s) * np.pi / 2) ** 2
        al = al / al[0]
        betas = np.clip(1 - al[1:] / al[:-1], None, 0.999)
    else:
        raise ValueError(mode)
    betas = np.concatenate([[0.0], betas])
    alphas = 1.0 - betas
    alpha_bars = np.exp(np.cumsum(np.log(alphas)))
    sigmas_flex = np.sqrt(betas)
    sigmas_inflex = np.zeros_like(betas)
    sigmas_inflex[1:] = np.sqrt(
        (1 - alpha_bars[:-1]) / (1 - alpha_bars[1:]) * betas[1:])

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return VarianceSchedule(f32(betas), f32(alphas), f32(alpha_bars),
                            f32(sigmas_flex), f32(sigmas_inflex), num_steps)


def diffusion_loss(net_apply: Callable, sched: VarianceSchedule, x0, context,
                   loss_mask=None, generator=None, t=None, eps=None):
    """Epsilon-prediction MSE of each scene.

    x0 (*B, A, T, 2) raw target velocities of A agents per scene, for
    leading scene axes B (none for one scene); context (*B, A, F);
    loss_mask (*B, A, T), True = ignore. ``net_apply(x_t, beta, context)``
    sees the leading axes. The diffusion step t (*B, A) of each agent and
    the noise eps (x0's shape) are drawn with ``generator`` unless given.
    Returns (*B): each scene's masked mean, as the reference returns for
    one scene under ``vmap``.
    """
    if t is None:
        t = torch.randint(1, sched.num_steps + 1, x0.shape[:-2],
                          generator=generator, device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                          dtype=x0.dtype)
    alpha_bar = sched.alpha_bars[t]
    beta = sched.betas[t]
    c0 = torch.sqrt(alpha_bar)[..., None, None]
    c1 = torch.sqrt(1 - alpha_bar)[..., None, None]
    e_theta = net_apply(c0 * x0 + c1 * eps, beta, context)
    err = (e_theta - eps) ** 2
    if loss_mask is None:
        return err.mean(dim=(-3, -2, -1))
    keep = (~loss_mask)[..., None].to(err.dtype)
    n = keep.sum(dim=(-3, -2, -1)) * err.shape[-1] / keep.shape[-1]
    return (err * keep).sum(dim=(-3, -2, -1)) / torch.clamp(n, min=1.0)


def nfe_count(num_steps: int = 100, stride: int = 2) -> int:
    """Denoiser evaluations per sampling call (a closed form of the
    static schedule)."""
    return len(np.arange(num_steps, 0, -stride))


def _draw(shape, lead, generator, device):
    """Standard normal noise of ``lead + shape``: from ``generator``, or
    for one leading episode axis from a sequence of generators, one per
    episode, each drawing what it would draw for its episode alone."""
    if not lead:
        return torch.randn(shape, generator=generator, device=device)
    if (len(lead) != 1 or not isinstance(generator, (list, tuple))
            or len(generator) != lead[0]):
        raise ValueError(f"sample: episode axes {tuple(lead)} need one axis "
                         "and one generator per episode")
    return torch.stack([torch.randn(shape, generator=g, device=device)
                        for g in generator])


def sample(net_apply: Callable, sched: VarianceSchedule, n_samples: int,
           context, horizon: int, point_dim: int = 2,
           sampling: str = "ddim", stride: int = 2, flexibility: float = 0.0,
           bestof: bool = True, generator=None, x_T=None, noise=None):
    """Reverse diffusion, all samples x agents in one batch.

    net_apply(x_t (*E, bs, horizon, point_dim), beta (*E, bs), ctx
    (*E, bs, F)) -> eps_hat, with context (*E, B, F) for B agents in each
    of the leading episode axes E (none for one scene), bs = n_samples * B
    and ``ctx`` the context tiled sample major.

    ``sampling`` is "ddim" (deterministic after the start) or "ddpm"
    (``alphas[t]`` even when strided, as the reference; noise sigma z with
    sigma mixing the two schedules' sigmas by ``flexibility``, and z drawn
    only while t > 1). ``bestof`` starts from standard normal noise,
    otherwise from zeros. ``x_T`` (*E, bs, horizon, point_dim) replaces the
    drawn start noise and ``noise`` (steps, *E, bs, horizon, point_dim)
    the per-step draws of DDPM (tests inject the reference's); what is not
    given is drawn with ``generator`` (for one episode axis, a sequence of
    generators, one per episode), the start first, then each step's.
    Returns (*E, n_samples, B, horizon, point_dim).
    """
    if sampling not in ("ddim", "ddpm"):
        raise ValueError(sampling)
    *lead, B, _ = context.shape
    bs = n_samples * B
    shape = (bs, horizon, point_dim)
    ctx = context.repeat(*(1,) * len(lead), n_samples, 1)
    if not bestof:
        if x_T is not None:
            raise ValueError("sample: bestof=False starts from zeros; x_T "
                             "must be None")
        x_T = torch.zeros((*lead, *shape), device=context.device)
    elif x_T is None:
        x_T = _draw(shape, lead, generator, context.device)
    x_t = x_T.to(context.dtype)

    # per-step coefficients, elementwise as the reference computes them
    sqrt_ab = torch.sqrt(sched.alpha_bars)
    sqrt_1mab = torch.sqrt(1 - sched.alpha_bars)
    sigmas = (sched.sigmas_flex * flexibility +
              sched.sigmas_inflex * (1 - flexibility))
    steps = range(sched.num_steps, 0, -stride)
    with tracing.span("forecast.denoise"):
        # the denoiser's work, from host shapes: its passes, and the token
        # rows (episodes x samples x agents x horizon) of each pass
        tracing.count("denoise_passes", len(steps))
        tracing.count("denoise_rows", math.prod(x_t.shape[:-1]))
        for i, t in enumerate(steps):
            t_next = max(t - stride, 0)
            beta = sched.betas[t].expand(*lead, bs)
            e_theta = net_apply(x_t, beta, ctx)
            if sampling == "ddim":
                x0_t = (x_t - e_theta * sqrt_1mab[t]) / sqrt_ab[t]
                x_t = sqrt_ab[t_next] * x0_t + sqrt_1mab[t_next] * e_theta
                continue
            alpha = sched.alphas[t]
            c0 = 1.0 / torch.sqrt(alpha)
            c1 = (1 - alpha) / sqrt_1mab[t]
            x_t = c0 * (x_t - c1 * e_theta)
            if t > 1:
                z = (noise[i] if noise is not None else
                     _draw(shape, lead, generator, context.device))
                x_t = x_t + sigmas[t] * z.to(x_t.dtype)
    return x_t.reshape(*lead, n_samples, B, horizon, point_dim)

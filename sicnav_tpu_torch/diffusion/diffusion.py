"""Diffusion core: variance schedule, the epsilon loss and the DDIM
sampler (twin of ``sicnav_tpu/diffusion/diffusion.py``).

All samples x agents are denoised as one batch; the reverse loop over t is
a host loop. The schedule is computed in float64 with numpy and stored as
float32, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class VarianceSchedule(NamedTuple):
    betas: torch.Tensor        # (T+1,) padded with beta_0 = 0
    alphas: torch.Tensor
    alpha_bars: torch.Tensor
    sigmas_flex: torch.Tensor
    sigmas_inflex: torch.Tensor
    num_steps: int


def make_schedule(num_steps: int = 100, device=None) -> VarianceSchedule:
    """The reference's linear schedule (beta from 1e-4 to 5e-2) on
    ``device``; the cosine schedule is not ported yet."""
    betas = np.concatenate([[0.0], np.linspace(1e-4, 5e-2, num_steps)])
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


def sample(net_apply: Callable, sched: VarianceSchedule, n_samples: int,
           context, horizon: int, point_dim: int = 2, stride: int = 2,
           generator=None, x_T=None):
    """Reverse diffusion with DDIM (the reference's default sampler; DDPM
    is not ported yet): all samples x agents in one batch.

    net_apply(x_t (*E, bs, horizon, point_dim), beta (*E, bs), ctx
    (*E, bs, F)) -> eps_hat, with context (*E, B, F) for B agents in each
    of the leading episode axes E (none for one scene), bs = n_samples * B
    and ``ctx`` the context tiled sample major. ``x_T`` (*E, bs, horizon,
    point_dim) replaces the drawn start noise (tests inject the
    reference's); otherwise it is drawn with ``generator``, or for one
    episode axis with a sequence of generators, one per episode, each
    drawing what it would draw for its episode alone. Returns (*E,
    n_samples, B, horizon, point_dim).
    """
    *lead, B, _ = context.shape
    bs = n_samples * B
    ctx = context.repeat(*(1,) * len(lead), n_samples, 1)
    if x_T is None:
        shape = (bs, horizon, point_dim)
        if lead:
            if (len(lead) != 1 or not isinstance(generator, (list, tuple))
                    or len(generator) != lead[0]):
                raise ValueError(f"sample: episode axes {tuple(lead)} need "
                                 "one axis and one generator per episode")
            x_T = torch.stack([torch.randn(shape, generator=g,
                                           device=context.device)
                               for g in generator])
        else:
            x_T = torch.randn(shape, generator=generator,
                              device=context.device)
    x_t = x_T.to(context.dtype)

    # per-step coefficients, elementwise as the reference computes them
    sqrt_ab = torch.sqrt(sched.alpha_bars)
    sqrt_1mab = torch.sqrt(1 - sched.alpha_bars)
    for t in range(sched.num_steps, 0, -stride):
        t_next = max(t - stride, 0)
        beta = sched.betas[t].expand(*lead, bs)
        e_theta = net_apply(x_t, beta, ctx)
        x0_t = (x_t - e_theta * sqrt_1mab[t]) / sqrt_ab[t]
        x_t = sqrt_ab[t_next] * x0_t + sqrt_1mab[t_next] * e_theta
    return x_t.reshape(*lead, n_samples, B, horizon, point_dim)

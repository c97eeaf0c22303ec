"""KDE-based most-likely sample ranking (twin of
``sicnav_tpu/diffusion/kde.py``).

A Gaussian KDE over the joint (humans x xy) sample space per future
timestep (log-spaced bandwidths over the horizon, Cholesky whitening,
logsumexp likelihoods), normalized into importance weights, summed over the
horizon, then top-k selection. Joint (JMID) and independent (iMID) variants.
The pairwise part runs in plain PyTorch (ops/kde_plain.py).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen.ops.geometry import linspace
from portbench.reference.frozen.ops.kde_plain import kde_loglik_fused


def most_likely_samples(forecasts, num_ret_samples: int, joint: bool = True):
    """Rank forecast samples by KDE likelihood and return the top k.

    forecasts: (*B, S, H, T, 2) samples x humans x horizon x xy, for
    leading episode axes B (none for one episode). Returns (top_forecasts
    (*B, H, k, T, 2), log_weights (*B, H, k)), the top k in ascending
    likelihood as the reference returns them. The B episodes' groups go to
    the kernel in one call.
    """
    *lead, S, H, T, _ = forecasts.shape
    k = num_ret_samples
    if joint:
        preds = forecasts.movedim(-2, -4).reshape(-1, S, H * 2)
        bw = torch.exp(linspace(math.log(0.01), math.log(0.1), T,
                                device=forecasts.device))
        ll = kde_loglik_fused(preds, bw.expand(*lead, T).reshape(-1))
        ll = ll.reshape(*lead, T, S)
        ll = ll - torch.logsumexp(ll, dim=-1, keepdim=True)
        lik = ll.sum(dim=-2)                                   # (*B, S)
        top = torch.argsort(lik, dim=-1, stable=True)[..., -k:]
        top_fc = torch.take_along_dim(
            forecasts, top[..., None, None, None], dim=-4)     # (*B, k, H, T, 2)
        lw = torch.take_along_dim(lik, top, dim=-1)
        lw = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
        return top_fc.movedim(-4, -3), lw[..., None, :].expand(*lead, H, k)
    preds = forecasts.movedim(-4, -2).reshape(-1, S, 2)
    ll = kde_loglik_fused(preds, 0.05)                         # (B*H*T, S)
    ll = ll - torch.logsumexp(ll, dim=-1, keepdim=True)
    lik = ll.reshape(*lead, H, T, S).sum(dim=-2)               # (*B, H, S)
    top = torch.argsort(lik, dim=-1, stable=True)[..., -k:]    # (*B, H, k)
    fc_swap = forecasts.movedim(-4, -3)                        # (*B, H, S, T, 2)
    top_fc = torch.take_along_dim(fc_swap, top[..., None, None], dim=-3)
    lw = torch.take_along_dim(lik, top, dim=-1)
    lw = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
    return top_fc, lw

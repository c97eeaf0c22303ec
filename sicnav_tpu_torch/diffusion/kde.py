"""KDE-based most-likely sample ranking (twin of
``sicnav_tpu/diffusion/kde.py``).

A Gaussian KDE over the joint (humans x xy) sample space per future
timestep (log-spaced bandwidths over the horizon, Cholesky whitening,
logsumexp likelihoods), normalized into importance weights, summed over the
horizon, then top-k selection. Joint (JMID) and independent (iMID) variants.
The pairwise part runs in the hand-written kernel (ops/kde_cuda.py).
"""

from __future__ import annotations

import math

import torch

from sicnav_tpu_torch.ops.geometry import linspace
from sicnav_tpu_torch.ops.kde_cuda import kde_loglik_fused


def most_likely_samples(forecasts, num_ret_samples: int, joint: bool = True):
    """Rank forecast samples by KDE likelihood and return the top k.

    forecasts: (S, H, T, 2) samples x humans x horizon x xy. Returns
    (top_forecasts (H, k, T, 2), log_weights (H, k)), the top k in
    ascending likelihood as the reference returns them.
    """
    S, H, T, _ = forecasts.shape
    k = num_ret_samples
    if joint:
        preds = forecasts.permute(2, 0, 1, 3).reshape(T, S, H * 2)
        bw = torch.exp(linspace(math.log(0.01), math.log(0.1), T,
                                device=forecasts.device))
        ll = kde_loglik_fused(preds, bw)                       # (T, S)
        ll = ll - torch.logsumexp(ll, dim=1, keepdim=True)
        lik = ll.sum(dim=0)                                    # (S,)
        top = torch.argsort(lik, stable=True)[-k:]
        top_fc = forecasts[top].permute(1, 0, 2, 3)            # (H, k, T, 2)
        lw = lik[top]
        lw = lw - torch.logsumexp(lw, dim=0)
        return top_fc, lw[None, :].expand(H, k)
    preds = forecasts.permute(1, 2, 0, 3).reshape(H * T, S, 2)
    ll = kde_loglik_fused(preds, 0.05)                         # (H*T, S)
    ll = ll - torch.logsumexp(ll, dim=1, keepdim=True)
    lik = ll.reshape(H, T, S).sum(dim=1)                       # (H, S)
    top = torch.argsort(lik, dim=-1, stable=True)[:, -k:]      # (H, k)
    fc_swap = forecasts.permute(1, 0, 2, 3)                    # (H, S, T, 2)
    top_fc = torch.gather(fc_swap, 1,
                          top[:, :, None, None].expand(H, k, T, 2))
    lw = torch.gather(lik, 1, top)
    lw = lw - torch.logsumexp(lw, dim=1, keepdim=True)
    return top_fc, lw

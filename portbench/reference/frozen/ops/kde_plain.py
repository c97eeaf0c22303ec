"""Pairwise whitened-distance KDE log-likelihood, plain PyTorch only.

Frozen from ``sicnav_tpu_torch/ops/kde_cuda.py``: ``kde_loglik_plain``,
``kde_loglik_fused`` and ``kde_whiten`` as they are there, except that no
call goes to the hand-written kernel and the bandwidth follows the
samples' dtype, so the reference runs in float64 as well as float32.
"""

from __future__ import annotations

import math

import torch


def kde_loglik_plain(y_white, log_Z):
    """Plain PyTorch version: out[g, i] = logsumexp_j(-0.5 * d2_ij -
    log_Z[g]) with d2_ij = sum_d (y_i[d] - y_j[d])^2. (G, S, D), (G,) ->
    (G, S). It takes the distance in difference form, as the kernel does:
    d_ii is exactly 0 and no pair loses its distance to rounding when the
    samples lie far from the origin. The reference's Gram form,
    |y_i|^2 + |y_j|^2 - 2 y_i.y_j clamped at 0, is the same function, but in
    float32 at |y|^2 near 1e9 it misses d_ii = 0 by hundreds, so the CPU
    and the card would serve different top-k samples."""
    diff = y_white[:, :, None, :] - y_white[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    log_exp = -0.5 * d2 - log_Z[:, None, None]
    return torch.logsumexp(log_exp, dim=-1)


def kde_loglik_fused(preds, bandwidth):
    """(G, S, D) samples -> (G, S) KDE log-likelihood of each sample under
    its group, with per-group ``bandwidth`` (G,) or a scalar."""
    return kde_loglik_plain(*kde_whiten(preds, bandwidth))


def kde_whiten(preds, bandwidth):
    """The kernel's inputs for ``kde_loglik_fused``: whitened samples
    (G, S, D) and log-normalizers (G,), both contiguous."""
    G, S, D = preds.shape
    n = float(S)
    if torch.is_tensor(bandwidth):
        bw = bandwidth.to(preds.dtype).expand(G)
    else:
        bw = torch.full((G,), float(bandwidth), dtype=preds.dtype,
                        device=preds.device)
    bw = bw[:, None, None]

    diff = preds - preds.mean(dim=1, keepdim=True)
    cov = torch.einsum("gsd,gse->gde", diff, diff) / (n - 1)
    eye = torch.eye(D, dtype=preds.dtype, device=preds.device)
    scale_cov_inv = bw ** -2 * cov + eye * 1e-6
    # the _ex forms neither raise nor wait for the device, as JAX does not
    scale_cov, _ = torch.linalg.inv_ex(scale_cov_inv)
    L, _ = torch.linalg.cholesky_ex(scale_cov)
    L_inv, _ = torch.linalg.inv_ex(L)
    log_det = 2.0 * torch.log(torch.clamp(
        torch.diagonal(L, dim1=-2, dim2=-1), min=1e-20)).sum(dim=-1)
    log_Z = 0.5 * D * math.log(2 * math.pi) + 0.5 * log_det + math.log(n)

    y_white = torch.einsum("gsd,ged->gse", preds, L_inv) / bw
    return y_white.contiguous(), log_Z.contiguous()

"""Prediction metrics: ADE / FDE (min-of-k and most-likely), KDE-NLL,
scene-level SADE / SFDE, horizon fractions and obstacle violations (twin
of ``sicnav_tpu/diffusion/evaluation.py``).

The reference writes each metric for one agent (or one scene) and
``vmap``s it; here every function reduces over its trailing axes and
broadcasts over any leading ones, so a call scores every agent of every
scene at once. Samples are (..., S, T, 2) for one agent, (..., S, A, T, 2)
for a scene.
"""

from __future__ import annotations

import math

import torch

from sicnav_tpu_torch.diffusion.kde import most_likely_samples
from sicnav_tpu_torch.ops.geometry import point_to_segment_dist


def _last_step(mask):
    """Index of the last observed step: (mask.sum - 1) clamped at 0."""
    return torch.clamp(mask.to(torch.int64).sum(dim=-1) - 1, min=0)


def ade(pred, gt, mask=None):
    """pred (..., S, T, 2) samples; gt (..., T, 2); mask (..., T).
    Per-sample ADE (..., S)."""
    err = torch.linalg.norm(pred - gt[..., None, :, :], dim=-1)  # (..., S, T)
    if mask is None:
        return err.mean(dim=-1)
    w = mask.to(err.dtype)
    return (err * w[..., None, :]).sum(dim=-1) / \
        torch.clamp(w.sum(dim=-1), min=1.0)[..., None]


def fde(pred, gt, mask=None):
    """Final displacement error per sample (..., S), at the last observed
    step when ``mask`` is given."""
    T = pred.shape[-2]
    if mask is None:
        last = torch.full(gt.shape[:-2], T - 1, dtype=torch.int64,
                          device=gt.device)
    else:
        last = _last_step(mask)
    S = pred.shape[-3]
    p_last = torch.take_along_dim(
        pred, last[..., None, None, None].expand(*last.shape, S, 1, 2),
        dim=-2)[..., 0, :]
    g_last = torch.take_along_dim(gt, last[..., None, None].expand(
        *last.shape, 1, 2), dim=-2)[..., 0, :]
    return torch.linalg.norm(p_last - g_last[..., None, :], dim=-1)


def min_ade_fde(pred, gt, mask=None):
    """Best-of-k ADE / FDE, (...) each."""
    return ade(pred, gt, mask).amin(dim=-1), fde(pred, gt, mask).amin(dim=-1)


def kde_nll(pred, gt):
    """Per-timestep Gaussian-KDE negative log likelihood of the ground truth
    under the samples, averaged over T: the reference's scipy-exact path
    (Scott's factor S^(-1/6), unregularized sample covariance, each step's
    log-density clipped at -20 before the mean, NaN when any step's
    covariance is singular).

    pred (..., S, T, 2); gt (..., T, 2). Returns (...)."""
    S = pred.shape[-3]
    preds = pred.transpose(-3, -2)                            # (..., T, S, 2)
    bw = S ** (-1.0 / 6.0)
    diff = preds - preds.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...tsd,...tse->...tde", diff, diff) / (S - 1)
    cov = bw ** 2 * cov
    det = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    singular = (det <= 0.0).any(dim=-1)                        # (...)
    eye = torch.eye(2, dtype=cov.dtype, device=cov.device)
    cov_safe = torch.where(singular[..., None, None, None], eye, cov)
    cov_inv = torch.linalg.inv(cov_safe)
    logdet = torch.linalg.slogdet(cov_safe)[1]
    d = gt[..., :, None, :] - preds                            # (..., T, S, 2)
    mahal = torch.einsum("...tsd,...tde,...tse->...ts", d, cov_inv, d)
    log_kernel = -0.5 * mahal - \
        0.5 * (2 * math.log(2 * math.pi) + logdet)[..., None]
    ll = torch.logsumexp(log_kernel, dim=-1) - math.log(S)
    ll = torch.clamp(ll, min=-20.0)
    return torch.where(singular, torch.full_like(singular, math.nan,
                                                 dtype=ll.dtype),
                       -ll.mean(dim=-1))


def most_likely_ade_fde(pred, gt, agent_mask=None, step_mask=None,
                        joint: bool = True):
    """ADE / FDE of the sample the KDE ranks most likely.

    pred (*B, S, A, T, 2); gt (*B, A, T, 2); agent_mask (*B, A): absent
    agents are zeroed out of the ranking (their dims whiten to a constant
    that the per-group normalization cancels) and out of the means;
    step_mask (*B, A, T). Returns (ade, fde), (*B) each, averaged over the
    valid agents. The B scenes' rankings go to the kernel as one call."""
    A, T = gt.shape[-3], gt.shape[-2]
    if agent_mask is None:
        agent_mask = torch.ones(gt.shape[:-2], dtype=torch.bool,
                                device=gt.device)
    am = agent_mask[..., None, :, None, None]
    top, _ = most_likely_samples(torch.where(am, pred, torch.zeros_like(pred)),
                                 1, joint=joint)
    best = top[..., 0, :, :]                                    # (*B, A, T, 2)
    err = torch.linalg.norm(best - gt, dim=-1)                  # (*B, A, T)
    if step_mask is None:
        step_mask = torch.ones(err.shape, dtype=torch.bool, device=err.device)
    sm = step_mask.to(err.dtype)
    per_ade = (err * sm).sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1.0)
    per_fde = torch.take_along_dim(err, _last_step(step_mask)[..., None],
                                   dim=-1)[..., 0]
    w = agent_mask.to(err.dtype)
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    return (per_ade * w).sum(dim=-1) / wsum, (per_fde * w).sum(dim=-1) / wsum


def horizon_fraction_ade(pred, gt, mask=None, fractions=(0.25, 0.5, 0.75)):
    """Min-of-k ADE cut at fractions of the horizon. pred (..., S, T, 2);
    gt (..., T, 2). Returns a tuple of (...), one per fraction."""
    T = pred.shape[-2]
    outs = []
    for f in fractions:
        n = max(int(round(T * f)), 1)
        m = None if mask is None else mask[..., :n]
        outs.append(ade(pred[..., :n, :], gt[..., :n, :], m).amin(dim=-1))
    return tuple(outs)


def obstacle_violations(pred, walls, wall_mask, radius: float = 0.0):
    """Share of predicted trajectories with a point within ``radius`` of an
    active wall. pred (..., S, T, 2); walls (W, 2, 2); wall_mask (W,).
    Returns (...)."""
    d = point_to_segment_dist(walls[:, 0], walls[:, 1], pred[..., None, :])
    d = torch.where(wall_mask, d, torch.full_like(d, math.inf)).amin(dim=-1)
    return (d < radius).any(dim=-1).to(torch.float32).mean(dim=-1)


def scene_ade_fde(pred, gt, agent_mask, step_mask=None):
    """Scene-consistent SADE / SFDE: errors averaged over the valid agents
    of each joint sample before the min over samples.

    pred (*B, S, A, T, 2); gt (*B, A, T, 2); agent_mask (*B, A); step_mask
    (*B, A, T): partially observed agents count their observed steps only.
    Returns (sade, sfde), (*B) each: the best sample's by SADE."""
    err = torch.linalg.norm(pred - gt[..., None, :, :, :], dim=-1)  # (*B,S,A,T)
    w = agent_mask.to(err.dtype)[..., None, :]
    if step_mask is None:
        per_ade = err.mean(dim=-1)
        per_fde = err[..., -1]
    else:
        sm = step_mask.to(err.dtype)[..., None, :, :]
        per_ade = (err * sm).sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1.0)
        last = _last_step(step_mask)[..., None, :, None].expand(
            *err.shape[:-1], 1)
        per_fde = torch.take_along_dim(err, last, dim=-1)[..., 0]
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    sade = (per_ade * w).sum(dim=-1) / wsum                      # (*B, S)
    sfde = (per_fde * w).sum(dim=-1) / wsum
    best = torch.argmin(sade, dim=-1, keepdim=True)
    return (torch.take_along_dim(sade, best, dim=-1)[..., 0],
            torch.take_along_dim(sfde, best, dim=-1)[..., 0])

"""Pairwise whitened-distance KDE log-likelihood (twin of
``sicnav_tpu/ops/kde_pallas.py``).

``kde_loglik`` replaces the TPU kernel ``_kde_kernel``: for a CUDA tensor it
launches the hand-written kernel in ``csrc/kde.cu`` (bound with ctypes,
built at first use); for a CPU tensor it computes the same function with
``kde_loglik_plain``. There is no other path: a CUDA tensor the kernel
cannot take raises.

``kde_loglik_fused`` whitens the samples (``kde_whiten``: covariance,
Cholesky and inverse stay in ``torch.linalg``) and hands them to
``kde_loglik``. The reference
sends fewer than 32 groups to an XLA path with the same math; the port
launches its kernel for every CUDA call.
"""

from __future__ import annotations

import math

import torch

from sicnav_tpu_torch.ops import build

# the widest D the kernel takes (csrc/kde.cu instantiates it for D <= 64)
KDE_MAX_D = 64
# the most shared memory a block can have on Hopper (227 KB); the kernel
# opts in above the default 48 KB
_SMEM_LIMIT = 232448


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


def kde_loglik(y_white, log_Z):
    """KDE log-likelihood of each whitened sample under its group, (G, S).

    CUDA tensors go through the hand-written kernel (one launch, counted in
    ``kde_loglik.launches``); CPU tensors through ``kde_loglik_plain``.
    """
    if y_white.device.type == "cpu" and log_Z.device.type == "cpu":
        return kde_loglik_plain(y_white, log_Z)
    if y_white.device.type != "cuda" or log_Z.device != y_white.device:
        raise ValueError(f"kde_loglik: y_white on {y_white.device} and log_Z "
                         f"on {log_Z.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if y_white.dtype != torch.float32 or log_Z.dtype != torch.float32:
        raise TypeError("kde_loglik: the kernel takes float32 tensors")
    if y_white.dim() != 3:
        raise ValueError(f"kde_loglik: y_white must be (G, S, D), got "
                         f"{tuple(y_white.shape)}")
    G, S, D = y_white.shape
    if tuple(log_Z.shape) != (G,):
        raise ValueError(f"kde_loglik: log_Z must be ({G},), got "
                         f"{tuple(log_Z.shape)}")
    if not (y_white.is_contiguous() and log_Z.is_contiguous()):
        raise ValueError("kde_loglik: the kernel takes contiguous tensors")
    check_kernel_shape(S, D)
    out = torch.empty((G, S), dtype=torch.float32, device=y_white.device)
    lib = build.load_library()
    with torch.cuda.device(y_white.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sicnav_kde_loglik(y_white.data_ptr(), log_Z.data_ptr(),
                                    out.data_ptr(), G, S, D, stream)
    if err != 0:
        raise RuntimeError(f"kde_loglik: kernel launch failed, cudaError {err}")
    kde_loglik.launches += 1
    return out


kde_loglik.launches = 0


def check_kernel_shape(S, D):
    """Raise unless the kernel takes groups of S samples of width D: D up
    to KDE_MAX_D, and a block's shared memory, the group's samples
    transposed to [D][S | 1] floats, within _SMEM_LIMIT."""
    if D > KDE_MAX_D:
        raise ValueError(f"kde_loglik: the kernel takes D <= {KDE_MAX_D}, "
                         f"got D={D}")
    smem = 4 * D * (S | 1)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kde_loglik: S={S}, D={D} needs {smem} bytes of "
                         f"shared memory; the kernel takes at most "
                         f"{_SMEM_LIMIT}")


def kde_loglik_fused(preds, bandwidth):
    """(G, S, D) samples -> (G, S) KDE log-likelihood of each sample under
    its group, with per-group ``bandwidth`` (G,) or a scalar."""
    return kde_loglik(*kde_whiten(preds, bandwidth))


def kde_whiten(preds, bandwidth):
    """The kernel's inputs for ``kde_loglik_fused``: whitened samples
    (G, S, D) and log-normalizers (G,), both contiguous."""
    G, S, D = preds.shape
    n = float(S)
    if torch.is_tensor(bandwidth):
        bw = bandwidth.to(torch.float32).expand(G)
    else:
        bw = torch.full((G,), float(bandwidth), dtype=torch.float32,
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

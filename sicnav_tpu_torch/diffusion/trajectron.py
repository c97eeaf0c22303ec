"""Trajectron++ CVAE machinery (twin of ``sicnav_tpu/diffusion/trajectron.py``):
the discrete latent, the bivariate Gaussian mixture GMM2D, the map encoder,
unicycle dynamics and a compact CVAE trajectory model.

The exercised MID path conditions the denoiser on the encoder's context
alone, so nothing there calls this module; it completes the component
inventory. Distributions are NamedTuples of tensors with plain functions,
the decoder is a host loop over the horizon, and every draw can be handed
in (``generator`` otherwise), so tests inject the reference's.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from sicnav_tpu_torch.diffusion.models import (
    LSTMEncoder, ModelConfig, TrajectronEncoder, integrate_velocity_samples,
    standardize_history,
)

# ---------------------------------------------------------------------------
# GMM2D


class GMM2D(NamedTuple):
    """Mixture of bivariate normals: log_pis (..., N), mus and log_sigmas
    (..., N, 2), corrs (..., N)."""
    log_pis: torch.Tensor
    mus: torch.Tensor
    log_sigmas: torch.Tensor
    corrs: torch.Tensor


def make_gmm2d(log_pis, mus, log_sigmas, corrs) -> GMM2D:
    """Normalizes the mixture logits (clipped below at -1e5); mus and
    log_sigmas may come flattened (..., N*2)."""
    n = log_pis.shape[-1]
    if mus.shape[-1] != 2:
        mus = mus.reshape(*mus.shape[:-1], n, 2)
    if log_sigmas.shape[-1] != 2:
        log_sigmas = log_sigmas.reshape(*log_sigmas.shape[:-1], n, 2)
    log_pis = torch.clamp(log_pis, min=-1e5)
    log_pis = log_pis - torch.logsumexp(log_pis, -1, keepdim=True)
    return GMM2D(log_pis, mus, log_sigmas, corrs)


def gmm2d_from_cov(log_pis, mus, cov_mats) -> GMM2D:
    """A mixture from 2 x 2 covariance matrices (..., N, 2, 2)."""
    s1 = torch.clamp(cov_mats[..., 0, 0], min=1e-8)
    s2 = torch.clamp(cov_mats[..., 1, 1], min=1e-8)
    sigmas = torch.stack([torch.sqrt(s1), torch.sqrt(s2)], -1)
    corrs = cov_mats[..., 0, 1] / sigmas.prod(-1)
    return make_gmm2d(log_pis, mus, torch.log(sigmas), corrs)


def gmm2d_log_prob(g: GMM2D, value):
    """Log density of the mixture at ``value`` (..., 2)."""
    sigmas = torch.exp(g.log_sigmas)
    omr2 = torch.clamp(1.0 - g.corrs ** 2, 1e-5, 1.0)
    dx = value[..., None, :] - g.mus                            # (..., N, 2)
    expn = (((dx / sigmas) ** 2).sum(-1)
            - 2 * g.corrs * dx.prod(-1) / sigmas.prod(-1))
    comp = -0.5 * (2 * np.log(2 * np.pi) + torch.log(omr2)
                   + 2 * g.log_sigmas.sum(-1) + expn / omr2)
    return torch.logsumexp(g.log_pis + comp, -1)


def _gmm2d_chol(g: GMM2D):
    sigmas = torch.exp(g.log_sigmas)
    omr2 = torch.clamp(1.0 - g.corrs ** 2, 1e-5, 1.0)
    zero = torch.zeros_like(g.corrs)
    row0 = torch.stack([sigmas[..., 0], zero], -1)
    row1 = torch.stack([sigmas[..., 1] * g.corrs,
                        sigmas[..., 1] * torch.sqrt(omr2)], -1)
    return torch.stack([row0, row1], -2)                       # (..., N, 2, 2)


def gmm2d_rsample(g: GMM2D, generator=None, z=None, comp=None):
    """mu + L z of a component picked from the mixture weights. ``z``
    (mus' shape, standard normal) and ``comp`` (..., component indices)
    are drawn with ``generator`` unless given."""
    if z is None:
        z = torch.randn(g.mus.shape, generator=generator,
                        device=g.mus.device)
    samples = g.mus + torch.einsum("...nij,...nj->...ni", _gmm2d_chol(g),
                                   z.to(g.mus.dtype))
    if comp is None:
        probs = torch.exp(g.log_pis).reshape(-1, g.log_pis.shape[-1])
        comp = torch.multinomial(probs, 1, generator=generator).reshape(
            g.log_pis.shape[:-1])
    sel = nn.functional.one_hot(comp.long(), g.log_pis.shape[-1])
    return (samples * sel[..., None].to(samples.dtype)).sum(-2)


def gmm2d_mode(g: GMM2D):
    """Mean of the most probable component."""
    comp = torch.argmax(g.log_pis, -1)
    sel = nn.functional.one_hot(comp, g.log_pis.shape[-1])
    return (g.mus * sel[..., None].to(g.mus.dtype)).sum(-2)


# ---------------------------------------------------------------------------
# the discrete latent


def latent_logits(h, N: int, K: int, logit_clip: Optional[float] = None):
    """(..., N*K) -> mean-zero (optionally clipped) per-factor logits
    (..., N, K)."""
    logits = h.reshape(*h.shape[:-1], N, K)
    logits = logits - logits.mean(-1, keepdim=True)
    if logit_clip is not None:
        logits = torch.clamp(logits, -logit_clip, logit_clip)
    return logits


def all_one_hot_combinations(N: int, K: int) -> np.ndarray:
    """(K^N, N*K) enumeration of every joint one-hot assignment."""
    out = np.zeros((K ** N, N * K), np.float32)
    for i, combo in enumerate(itertools.product(range(K), repeat=N)):
        for n, k in enumerate(combo):
            out[i, n * K + k] = 1.0
    return out


def _log_softmax(logits):
    return logits - torch.logsumexp(logits, -1, keepdim=True)


def kl_q_p(q_logits, p_logits, kl_min: float = 0.07):
    """Categorical KL(q || p) of each factor, its batch mean floored at
    kl_min, summed over the factors."""
    lq, lp = _log_softmax(q_logits), _log_softmax(p_logits)
    kl = (torch.exp(lq) * (lq - lp)).sum(-1)                     # (..., N)
    kl_mean = kl.reshape(-1, kl.shape[-1]).mean(0)
    return (torch.clamp(kl_mean, min=kl_min) if kl_min > 0 else kl_mean).sum()


def mutual_inf(logits):
    """Mutual information H(mean p) - mean H(p), summed over factors."""
    lp = _log_softmax(logits)
    p = torch.exp(lp)
    p_mean = p.reshape(-1, *p.shape[-2:]).mean(0)
    h_y = -(p_mean * torch.log(p_mean + 1e-12)).sum(-1)
    h_cond = -(p * lp).sum(-1)
    return (h_y - h_cond.reshape(-1, h_cond.shape[-1]).mean(0)).sum()


def sample_p(p_logits, num_samples: int, mode: str = "full", generator=None,
             draws=None):
    """Latent codes from p: (z (num_samples * components, B, N*K), the
    number of components). ``full`` enumerates all K^N assignments per
    sample; ``most_likely`` takes the argmax; ``sample`` draws each factor's
    class from p, ``draws`` (num_samples, B, N) class indices unless drawn
    with ``generator``."""
    B, N, K = p_logits.shape
    if mode == "full":
        combos = torch.as_tensor(all_one_hot_combinations(N, K),
                                 device=p_logits.device)
        z = combos[None, :, None, :].expand(num_samples, K ** N, B, N * K)
        return z.reshape(num_samples * K ** N, B, N * K), K ** N
    if mode == "most_likely":
        z = nn.functional.one_hot(torch.argmax(p_logits, -1), K)
        z = z.reshape(B, N * K).to(p_logits.dtype)
        return z[None].expand(num_samples, B, N * K), 1
    if draws is None:
        probs = torch.softmax(p_logits, -1).reshape(-1, K)
        draws = torch.stack([
            torch.multinomial(probs, 1, generator=generator).reshape(B, N)
            for _ in range(num_samples)])
    z = nn.functional.one_hot(draws.long(), K).reshape(num_samples, B, N * K)
    return z.to(p_logits.dtype), 1


# ---------------------------------------------------------------------------
# N-pair loss and the map encoder


def npair_loss(x, target, valid, tao: float = 1.0, l2_reg: float = 0.02):
    """The N-pair loss over every valid same-class pair (i, j) with every
    other-class k as a negative, as the reference computes it (a
    deterministic superset of a sampled anchor / positive estimator). Its
    l2 term is taken on L2-normalized embeddings, so it is the constant
    2 * l2_reg.

    x (A, D) embeddings; target (A,) class ids; valid (A,) bool."""
    e = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    s = e @ e.T                                                # (A, A)
    vv = valid[:, None] & valid[None, :]
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    same = (target[:, None] == target[None, :]) & vv & ~eye
    diff = (target[:, None] != target[None, :]) & vv
    # pair (i, j): a_i . (n_k - p_j) = s_ik - s_ij over negatives k
    z = (s[:, None, :] - s[:, :, None]) / tao                  # (i, j, k)
    ex = torch.where(diff[:, None, :], torch.exp(z), torch.zeros_like(z))
    pair_loss = torch.log1p(ex.sum(-1))                        # (i, j)
    n_pairs = same.sum()
    loss = torch.where(same, pair_loss, torch.zeros_like(pair_loss)).sum() / \
        torch.clamp(n_pairs, min=1)
    return torch.where(n_pairs > 0, loss + 2.0 * l2_reg,
                       torch.zeros_like(loss))


class CNNMapEncoder(nn.Module):
    """Conv stack (valid padding, leaky ReLU 0.2) and a dense layer over a
    local map patch, taken NHWC as the reference takes it (in_channels x
    input_size x input_size)."""

    def __init__(self, in_channels: int, input_size: int,
                 hidden_channels: Sequence[int] = (10, 20, 10, 1),
                 masks: Sequence[int] = (5, 5, 5, 3),
                 strides: Sequence[int] = (2, 2, 1, 1),
                 output_size: int = 32):
        super().__init__()
        convs, ch, hw = [], in_channels, input_size
        for out, m, s in zip(hidden_channels, masks, strides):
            convs.append(nn.Conv2d(ch, out, m, stride=s))
            ch, hw = out, (hw - m) // s + 1
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(ch * hw * hw, output_size)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)                              # NHWC -> NCHW
        for conv in self.convs:
            x = nn.functional.leaky_relu(conv(x), 0.2)
        # flattened in NHWC order, as the reference's dense layer reads it
        return self.dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


# ---------------------------------------------------------------------------
# unicycle dynamics


def unicycle_dynamic(x, u, dt: float):
    """One exact unicycle step. x = [px, py, phi, v], u = [dphi, a]; for
    |dphi| <= 1e-2 the straight-line second-order step (a branchless
    select with a safe divisor)."""
    px, py, phi, v = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    dphi_raw, a = u[..., 0], u[..., 1]
    straight = torch.abs(dphi_raw) <= 1e-2
    dphi = torch.where(straight, torch.ones_like(dphi_raw), dphi_raw)

    phi_n = phi + dphi * dt
    dsin = (torch.sin(phi_n) - torch.sin(phi)) / dphi
    dcos = (torch.cos(phi_n) - torch.cos(phi)) / dphi
    turn = torch.stack([
        px + (a / dphi) * dcos + v * dsin + (a / dphi) * torch.sin(phi_n) * dt,
        py - v * dcos + (a / dphi) * dsin - (a / dphi) * torch.cos(phi_n) * dt,
        phi + dphi * dt,
        v + a * dt,
    ], -1)
    line = torch.stack([
        px + v * torch.cos(phi) * dt + 0.5 * a * torch.cos(phi) * dt ** 2,
        py + v * torch.sin(phi) * dt + 0.5 * a * torch.sin(phi) * dt ** 2,
        phi,
        v + a * dt,
    ], -1)
    return torch.where(straight[..., None], line, turn)


def unicycle_integrate(controls, p0, v0, dt: float, phi_correction=0.0):
    """Roll [dphi, a] controls (..., T, 2) from positions p0 and velocities
    v0; the initial heading is atan2(v0) plus ``phi_correction``. Returns
    positions (..., T, 2)."""
    phi0 = torch.atan2(v0[..., 1], v0[..., 0]) + phi_correction
    x = torch.cat([p0, phi0[..., None],
                   torch.linalg.norm(v0, dim=-1)[..., None]], -1)
    pos = []
    for t in range(controls.shape[-2]):
        x = unicycle_dynamic(x, controls[..., t, :], dt)
        pos.append(x[..., 0:2])
    return torch.stack(pos, -2)


# ---------------------------------------------------------------------------
# the compact CVAE: encoder -> discrete latent -> GRU decoder emitting a
# GMM2D over the velocity of each step


class GRUCell(nn.Module):
    """Flax's GRU cell: r and z gates with biases on the input side, the
    candidate's recurrent term with its own bias inside the reset gate."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.ir = nn.Linear(in_dim, hidden)
        self.iz = nn.Linear(in_dim, hidden)
        self.in_ = nn.Linear(in_dim, hidden)
        self.hr = nn.Linear(hidden, hidden, bias=False)
        self.hz = nn.Linear(hidden, hidden, bias=False)
        self.hn = nn.Linear(hidden, hidden)

    def recurrent_kernels(self):
        """The kernels Flax draws orthogonal (``models.init_parameters``)."""
        return (self.hr.weight, self.hz.weight, self.hn.weight)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class CVAETrajectron(nn.Module):
    """The reference's compact MultimodalGenerativeCVAE, one scene (A
    agents) per call.

    - x: the shared TrajectronEncoder's context (history and edges).
    - the future encoder: a forward LSTM (32) over the future velocities.
    - q(z | x, y) and p(z | x): dense heads to N*K mean-zero logits.
    - p(y | x, z): a GRU over the horizon fed [z, x, previous mean], with a
      GMM2D's parameters projected each step (one component per latent
      class: the reference declares a mixture-weight head but never calls
      it, so it has no parameters). Training enumerates all K^N latent
      classes weighted by q (the exact discrete ELBO for N = 1).
    """

    def __init__(self, cfg: ModelConfig, latent_n: int = 1,
                 latent_k: int = 25, dec_rnn_dim: int = 128,
                 kl_min: float = 0.07, kl_weight: float = 1.0,
                 logit_clip: float = 5.0, npl_rate: float = 0.8,
                 device=None):
        super().__init__()
        from sicnav_tpu_torch.device import resolve_device
        device = resolve_device(device)
        self.cfg = cfg
        self.latent_n, self.latent_k = latent_n, latent_k
        self.kl_min, self.kl_weight = kl_min, kl_weight
        self.logit_clip, self.npl_rate = logit_clip, npl_rate
        x_dim = 2 * cfg.enc_rnn_dim
        nk = latent_n * latent_k
        self.encoder = TrajectronEncoder(cfg)
        self.node_future_encoder = LSTMEncoder(cfg.pred_dim, 32)
        self.q_z_xy = nn.Linear(x_dim + 32, nk)
        self.p_z_x = nn.Linear(x_dim, nk)
        self.decoder_state_action = nn.Linear(cfg.state_dim, 2)
        self.decoder_initial_h = nn.Linear(nk + x_dim, dec_rnn_dim)
        self.decoder_rnn_cell = GRUCell(nk + x_dim + 2, dec_rnn_dim)
        self.proj_to_GMM_mus = nn.Linear(dec_rnn_dim, 2)
        self.proj_to_GMM_log_sigmas = nn.Linear(dec_rnn_dim, 2)
        self.proj_to_GMM_corrs = nn.Linear(dec_rnn_dim, 1)
        self.to(device)

    def encode_x(self, batch):
        """The encoder's context of each agent (A, 2 * enc_rnn_dim), without
        dropout in either mode, as the reference encodes it."""
        was_training = self.encoder.training
        self.encoder.train(False)
        try:
            return self._encode_x(batch)
        finally:
            self.encoder.train(was_training)

    def _encode_x(self, batch):
        A = batch.hist.shape[0]
        cur_pos = batch.hist[:, -1, 0:2]
        hist_st = standardize_history(batch.hist, cur_pos)
        neigh = batch.hist[None].expand(A, *batch.hist.shape)
        neigh_st = standardize_history(neigh, cur_pos[:, None, :].expand(
            A, A, 2))
        return self.encoder(hist_st, batch.hist_mask, neigh_st,
                            batch.neighbor_mask)

    def encode_future(self, batch):
        return self.node_future_encoder(batch.fut_vel, batch.fut_mask)

    def _decode(self, z, x, a0, T):
        """The GRU rollout over leading axes: (mus (..., T, 2), log_sigmas
        (..., T, 2), corrs (..., T))."""
        zx = torch.cat([z, x], -1)
        state = self.decoder_initial_h(zx)
        inp = torch.cat([zx, a0], -1)
        mus, log_sigmas, corrs = [], [], []
        for _ in range(T):
            state = self.decoder_rnn_cell(state, inp)
            mu = self.proj_to_GMM_mus(state)
            mus.append(mu)
            log_sigmas.append(self.proj_to_GMM_log_sigmas(state))
            corrs.append(torch.tanh(self.proj_to_GMM_corrs(state))[..., 0])
            # the mean action feeds the next step
            inp = torch.cat([zx, mu], -1)
        return (torch.stack(mus, -2), torch.stack(log_sigmas, -2),
                torch.stack(corrs, -1))

    def train_loss(self, batch):
        """-ELBO (exact over the latent classes) + npl_rate * the N-pair
        loss of the context by its most likely latent class."""
        T = self.cfg.horizon
        x = self.encode_x(batch)
        y_e = self.encode_future(batch)
        q_logits = latent_logits(self.q_z_xy(torch.cat([x, y_e], -1)),
                                 self.latent_n, self.latent_k,
                                 self.logit_clip)
        p_logits = latent_logits(self.p_z_x(x), self.latent_n, self.latent_k)
        a0 = self.decoder_state_action(batch.hist[:, -1])
        combos = torch.as_tensor(all_one_hot_combinations(
            self.latent_n, self.latent_k), device=x.device)
        C, A = combos.shape[0], x.shape[0]
        z_all = combos[:, None, :].expand(C, A, combos.shape[1])
        x_all = x[None].expand(C, *x.shape)
        a0_all = a0[None].expand(C, *a0.shape)
        mus, log_sigmas, corrs = self._decode(z_all, x_all, a0_all, T)
        # a mixture over the latent classes weighted by q (exact for N = 1)
        lq = _log_softmax(q_logits).reshape(A, -1)              # (A, C)
        g = make_gmm2d(lq[:, None, :].expand(A, T, C),
                       mus.movedim(0, -2), log_sigmas.movedim(0, -2),
                       corrs.movedim(0, -1))
        log_p = gmm2d_log_prob(g, batch.fut_vel)                # (A, T)
        keep = (batch.fut_mask & batch.agent_mask[:, None]).to(log_p.dtype)
        log_likelihood = (log_p * keep).sum() / torch.clamp(keep.sum(),
                                                            min=1.0)
        kl = kl_q_p(q_logits, p_logits, self.kl_min)
        elbo = log_likelihood - self.kl_weight * kl + mutual_inf(p_logits)
        x_target = torch.argmax(p_logits.reshape(A, -1), -1)
        npl = npair_loss(x, x_target, batch.agent_mask)
        return -elbo + self.npl_rate * npl

    def forward(self, batch):
        return self.train_loss(batch)

    def predict(self, batch, num_samples: int, z_mode: str = "most_likely",
                gmm_mode: bool = True, dt: float = 0.25, generator=None,
                z_draws=None, y_noise=None, y_comp=None):
        """Sample z from p(z | x), decode, integrate the velocities:
        (positions (S, A, T, 2), the number of latent components). The
        latent draws (``sample_p``'s ``draws``) and, without ``gmm_mode``,
        the GMM2D draws (``gmm2d_rsample``'s ``z`` and ``comp``) come from
        ``generator`` unless given."""
        T = self.cfg.horizon
        x = self.encode_x(batch)
        p_logits = latent_logits(self.p_z_x(x), self.latent_n, self.latent_k)
        z, n_comp = sample_p(p_logits, num_samples, z_mode, generator,
                             z_draws)
        a0 = self.decoder_state_action(batch.hist[:, -1])
        S = z.shape[0]
        mus, log_sigmas, corrs = self._decode(
            z, x[None].expand(S, *x.shape), a0[None].expand(S, *a0.shape), T)
        g = make_gmm2d(torch.zeros(*corrs.shape, 1, device=x.device),
                       mus[..., None, :], log_sigmas[..., None, :],
                       corrs[..., None])
        vel = gmm2d_mode(g) if gmm_mode else gmm2d_rsample(
            g, generator, y_noise, y_comp)
        p0 = batch.hist[:, -1, 0:2]
        return integrate_velocity_samples(vel, p0[None], dt), n_comp

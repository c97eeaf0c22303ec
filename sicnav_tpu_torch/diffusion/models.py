"""JMID networks as ``nn.Module``s (twin of ``sicnav_tpu/diffusion/models.py``).

- ``TrajectronEncoder``: node-history LSTM + summed neighbour-edge LSTM +
  additive attention over edge types -> the denoiser's context.
- ``JointTransformerConcatLinear``: the JMID denoiser, ConcatSquash in/out
  layers conditioned on [beta, sin beta, cos beta, context] around a
  post-norm transformer over all (agent x horizon) tokens of a scene with a
  block-diagonal mask.

Layers follow the reference's Flax definitions so that ``convert.py`` can
load its parameters: Flax's LSTM gate order (i, f, g, o) with input kernels
unbiased, Flax's attention (query scaled before the product, fully masked
rows uniform rather than NaN) and Flax's LayerNorm (epsilon 1e-6, variance
as E[x^2] - E[x]^2). Dropout sits where Flax has it (the encoder's three
``rnn_dropout`` sites; in each transformer layer the attention weights,
after attention, inside and after the feed-forward) and acts in
``train()`` mode only, with its masks drawn from the ``generator`` handed
to ``forward``, so that a seed decides a training run.
Only the single-class encoder and the joint default denoiser are ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

ATTENTION_RADIUS = 3.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's model configuration, field for field."""
    context_dim: int = 256          # encoder_dim in the yaml configs
    enc_rnn_dim: int = 128          # history / edge LSTM size
    tf_layer: int = 3
    n_heads: int = 4
    state_dim: int = 6              # pos, vel, acc
    pred_dim: int = 2               # velocity
    history_len: int = 6            # max_ht + 1 frames of history (incl now)
    horizon: int = 8
    dropout: float = 0.1
    rnn_dropout: float = 0.25
    diffnet: str = ""
    residual: bool = False
    num_node_types: int = 1


def dropout(x, rate: float, generator=None, shape=None):
    """Flax's ``Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate). The keep mask, drawn from ``generator``,
    has ``shape`` (broadcast over x; x's own shape by default)."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class LSTMEncoder(nn.Module):
    """LSTM over (..., T, D) sequences that holds its state through frames
    where ``valid_mask`` is False; returns the last hidden state."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        # gate order (i, f, g, o) along the output axis
        self.w_i = nn.Linear(in_dim, 4 * hidden, bias=False)
        self.w_h = nn.Linear(hidden, 4 * hidden)

    def forward(self, seq, valid_mask):
        lead = seq.shape[:-2]
        T = seq.shape[-2]
        flat = seq.reshape(-1, T, seq.shape[-1])
        vmask = valid_mask.reshape(-1, T, 1)
        x_proj = self.w_i(flat)                               # (N, T, 4H)
        c = flat.new_zeros(flat.shape[0], self.hidden)
        h = flat.new_zeros(flat.shape[0], self.hidden)
        for t in range(T):
            i, f, g, o = (self.w_h(h) + x_proj[:, t]).chunk(4, dim=-1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            c = torch.where(vmask[:, t], new_c, c)
            h = torch.where(vmask[:, t], new_h, h)
        return h.reshape(*lead, self.hidden)


class AdditiveAttention(nn.Module):
    """Bahdanau additive attention."""

    def __init__(self, key_dim: int, query_dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(key_dim, hidden, bias=False)
        self.w2 = nn.Linear(query_dim, hidden, bias=False)
        self.v = nn.Linear(hidden, 1, bias=False)

    def forward(self, keys, query):
        # keys: (..., N, D_k), query: (..., D_q)
        scores = self.v(torch.tanh(self.w1(keys) + self.w2(query)[..., None, :]))[..., 0]
        attn = torch.softmax(scores, dim=-1)
        return (attn[..., None] * keys).sum(dim=-2), attn


class TrajectronEncoder(nn.Module):
    """History + edge encoder producing the diffusion conditioning context.

    hist (..., T_h, 6) standardized; hist_mask (..., T_h); neigh_hist
    (..., N, T_h, 6); neigh_mask (..., N). Output (..., 2 * enc_rnn_dim).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.rnn_dropout = cfg.rnn_dropout
        if cfg.num_node_types > 1:
            raise NotImplementedError(
                "class-conditioned encoders (num_node_types > 1) are not "
                "ported yet")
        H = cfg.enc_rnn_dim
        self.history_lstm = LSTMEncoder(cfg.state_dim, H)
        self.edge_lstm = LSTMEncoder(2 * cfg.state_dim, H)
        self.edge_attention = AdditiveAttention(H, H, H)

    def forward(self, hist, hist_mask, neigh_hist, neigh_mask,
                generator=None):
        rate = self.rnn_dropout if self.training else 0.0

        def drop(x):
            return dropout(x, rate, generator)

        h_enc = drop(self.history_lstm(hist, hist_mask))
        # edge: sum-combine neighbour states over the slot axis
        combined = torch.where(neigh_mask[..., None, None], neigh_hist,
                               torch.zeros_like(neigh_hist)).sum(dim=-3)
        joint = torch.cat([combined, hist], dim=-1)
        e_enc = self.edge_lstm(joint, hist_mask)
        # dynamic-edge mask: zero influence when no neighbours at all
        e_enc = drop(e_enc * neigh_mask.any(dim=-1)[..., None])
        e_infl, _ = self.edge_attention(e_enc[..., None, :], h_enc)
        return torch.cat([drop(e_infl), h_enc], dim=-1)


class ConcatSquashLinear(nn.Module):
    """out = W x * sigmoid(W_g ctx) + W_b ctx."""

    def __init__(self, in_dim: int, ctx_dim: int, out_dim: int):
        super().__init__()
        self.layer = nn.Linear(in_dim, out_dim)
        self.hyper_gate = nn.Linear(ctx_dim, out_dim)
        self.hyper_bias = nn.Linear(ctx_dim, out_dim, bias=False)

    def forward(self, ctx, x):
        return self.layer(x) * torch.sigmoid(self.hyper_gate(ctx)) + \
            self.hyper_bias(ctx)


def positional_encoding(T, d_model):
    pos = np.arange(T)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((T, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.as_tensor(pe)


class LayerNorm(nn.Module):
    """Flax's LayerNorm: epsilon 1e-6, variance as E[x^2] - E[x]^2."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class MultiHeadAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` (self-attention).

    A masked logit is set to the float32 minimum, as in Flax, so a row with
    every key masked (an absent agent's tokens) comes out uniform instead of
    NaN; NaN rows would reach every token through the next layer. In train
    mode the attention weights take dropout with one mask for all heads, as
    Flax's ``broadcast_dropout`` draws it.
    """

    def __init__(self, d_model: int, n_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask, generator=None):
        """x (..., N, d); mask bool, True = attend, broadcastable to the
        weights (..., heads, N, N)."""
        *lead, N, _ = x.shape
        shape = (*lead, N, self.n_heads, self.head_dim)
        q = self.query(x).view(shape) / math.sqrt(self.head_dim)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        w = torch.einsum("...qhd,...khd->...hqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        w = dropout(w, self.dropout_rate if self.training else 0.0,
                    generator, (*lead, 1, N, N))
        o = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out(o.reshape(*lead, N, -1))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch nn.TransformerEncoderLayer layout)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attn = MultiHeadAttention(d_model, n_heads, dropout_rate)
        self.norm0 = LayerNorm(d_model)
        self.ff0 = nn.Linear(d_model, d_ff)
        self.ff1 = nn.Linear(d_ff, d_model)
        self.norm1 = LayerNorm(d_model)

    def forward(self, x, mask, generator=None):
        rate = self.dropout_rate if self.training else 0.0

        def drop(y):
            return dropout(y, rate, generator)

        x = self.norm0(x + drop(self.attn(x, mask, generator)))
        ff = self.ff1(drop(torch.relu(self.ff0(x))))
        return self.norm1(x + drop(ff))


def _time_context(beta, context):
    """[beta, sin beta, cos beta, context] per agent: (..., 1, 3 + F)."""
    b = beta[..., None, None]
    time_emb = torch.cat([b, torch.sin(b), torch.cos(b)], dim=-1)
    return torch.cat([time_emb, context[..., None, :]], dim=-1)


class JointTransformerConcatLinear(nn.Module):
    """JMID denoiser: attention across all (agent x horizon) tokens of a
    scene with a block-diagonal mask."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = 2 * cfg.context_dim
        ctx_dim = 3 + 2 * cfg.enc_rnn_dim
        self.concat1 = ConcatSquashLinear(cfg.pred_dim, ctx_dim, d)
        self.tf = nn.ModuleList(
            TransformerEncoderLayer(d, cfg.n_heads, 4 * cfg.context_dim,
                                    cfg.dropout)
            for _ in range(cfg.tf_layer))
        self.concat3 = ConcatSquashLinear(d, ctx_dim, cfg.context_dim)
        self.concat4 = ConcatSquashLinear(cfg.context_dim, ctx_dim,
                                          cfg.context_dim // 2)
        self.linear = ConcatSquashLinear(cfg.context_dim // 2, ctx_dim,
                                         cfg.pred_dim)
        self.register_buffer("pe", positional_encoding(cfg.horizon, d),
                             persistent=False)

    def forward(self, x, beta, context, scene_mask, generator=None):
        """x (*B, S, A, T, 2); beta (*B, S, A); context (*B, S, A, F);
        scene_mask (*B, A*T, A*T) bool, True = attend. One scene per
        leading index; the B axes (episodes) each have their own mask.
        ``generator`` draws the dropout masks in train mode."""
        *lead, A, T, _ = x.shape
        ctx = _time_context(beta, context)                  # (..., A, 1, 3+F)
        h = self.concat1(ctx, x)
        h = h + self.pe[:T]
        h = h.reshape(*lead, A * T, -1)
        # the mask broadcasts over the samples and the heads
        mask = scene_mask[..., None, None, :, :]
        for layer in self.tf:
            h = layer(h, mask, generator)
        h = h.reshape(*lead, A, T, -1)
        h = self.concat3(ctx, h)
        h = self.concat4(ctx, h)
        return self.linear(ctx, h)


def init_parameters(module: nn.Module, generator=None):
    """Flax's initializers in place: ``lecun_normal`` kernels (a normal cut
    at two standard deviations, std sqrt(1 / fan_in) / 0.8796), orthogonal
    recurrent LSTM kernels per gate, zero biases, LayerNorm scale 1 and
    bias 0; drawn from ``generator``, a CPU generator."""
    def draw(param, init, **kw):
        # drawn on the CPU, so one seed gives one model on every device
        x = torch.empty(param.shape)
        init(x, generator=generator, **kw)
        param.copy_(x)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / .87962566103423978
                draw(m.weight, nn.init.trunc_normal_, std=std, a=-2 * std,
                     b=2 * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if isinstance(m, LSTMEncoder):
                for gate in m.w_h.weight.split(m.hidden):
                    draw(gate, nn.init.orthogonal_)


def make_denoiser(cfg: ModelConfig, joint: bool):
    """The mode's default denoiser as (module, is_joint). Only the joint
    default (JMID) is ported so far."""
    name = cfg.diffnet or ("JointPredictionTransformerConcatLinear" if joint
                           else "TransformerConcatLinear")
    if name != "JointPredictionTransformerConcatLinear":
        raise NotImplementedError(f"denoiser {name!r} is not ported yet")
    return JointTransformerConcatLinear(cfg), True


def standardize_history(hist_raw, current_pos):
    """(..., T, 6) raw [pos, vel, acc] -> standardized: positions relative
    to ``current_pos`` over the attention radius; vel/2; acc/1."""
    rel_pos = hist_raw[..., 0:2] - current_pos[..., None, :]
    return torch.cat([rel_pos / ATTENTION_RADIUS, hist_raw[..., 2:4] / 2.0,
                      hist_raw[..., 4:6] / 1.0], dim=-1)


def integrate_velocity_samples(vel, p0, dt):
    """Single-integrator integration: positions = p0 + cumsum(vel) * dt."""
    return p0[..., None, :] + torch.cumsum(vel, dim=-2) * dt

"""JMID networks as ``nn.Module``s (twin of ``sicnav_tpu/diffusion/models.py``).

- ``TrajectronEncoder``: node-history LSTM + summed neighbour-edge LSTM +
  additive attention over edge types -> the denoiser's context.
- ``JointTransformerConcatLinear``: the JMID denoiser, ConcatSquash in/out
  layers conditioned on [beta, sin beta, cos beta, context] around a
  post-norm transformer over all (agent x horizon) tokens of a scene with a
  block-diagonal mask.
- ``TransformerConcatLinear``: the iMID denoiser, the same layers with
  attention over one agent's horizon tokens; and the rest of the
  reference's denoiser family (``TrajNet``, ``TransformerLinear``,
  ``SmallMLP`` / ``BigMLP``, the agent-token
  ``JointInstanceTransformerConcatLinear`` v1-v3), resolved by name through
  ``DIFFNETS`` / ``make_denoiser``; ``LinearDecoder``.

Layers follow the reference's Flax definitions so that ``convert.py`` can
load its parameters: Flax's LSTM gate order (i, f, g, o) with input kernels
unbiased, Flax's attention (query scaled before the product, fully masked
rows uniform rather than NaN) and Flax's LayerNorm (epsilon 1e-6, variance
as E[x^2] - E[x]^2). Dropout sits where Flax has it (the encoder's three
``rnn_dropout`` sites; in each transformer layer the attention weights,
after attention, inside and after the feed-forward) and acts in
``train()`` mode only, with its masks drawn from the ``generator`` handed
to ``forward``, so that a seed decides a training run.

With ``num_node_types > 1`` the encoder is class-conditioned, as the
reference's: a 16-wide class embedding is appended to every history frame,
the neighbours' class embedding to every edge frame, and a dense map of the
class embedding is added to the context.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

ATTENTION_RADIUS = 3.0
CLASS_EMBED_DIM = 16            # the class embeddings' width


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
        H = cfg.enc_rnn_dim
        in_dim = cfg.state_dim
        self.classes = cfg.num_node_types > 1
        if self.classes:
            in_dim += CLASS_EMBED_DIM
            self.class_embed = nn.Embedding(cfg.num_node_types,
                                            CLASS_EMBED_DIM)
            self.edge_class_embed = nn.Embedding(cfg.num_node_types,
                                                 CLASS_EMBED_DIM)
            self.class_film = nn.Linear(CLASS_EMBED_DIM, 2 * H)
        self.history_lstm = LSTMEncoder(in_dim, H)
        self.edge_lstm = LSTMEncoder(2 * in_dim, H)
        self.edge_attention = AdditiveAttention(H, H, H)

    def forward(self, hist, hist_mask, neigh_hist, neigh_mask,
                generator=None, node_type=None, neigh_type=None):
        """``node_type`` (...) and ``neigh_type`` (..., N) are class codes
        (all 0 when None) for a class-conditioned encoder; a single-class
        encoder ignores them."""
        rate = self.rnn_dropout if self.training else 0.0

        def drop(x):
            return dropout(x, rate, generator)

        emb = None
        if self.classes:
            # every history frame carries the agent's class, every edge
            # frame its neighbour's
            if node_type is None:
                node_type = torch.zeros(hist.shape[:-2], dtype=torch.long,
                                        device=hist.device)
            if neigh_type is None:
                neigh_type = torch.zeros(neigh_hist.shape[:-2],
                                         dtype=torch.long,
                                         device=hist.device)
            emb = self.class_embed(node_type.long())
            hist = torch.cat([hist, emb[..., None, :].expand(
                *hist.shape[:-1], CLASS_EMBED_DIM)], dim=-1)
            n_emb = self.edge_class_embed(neigh_type.long())
            neigh_hist = torch.cat([neigh_hist, n_emb[..., None, :].expand(
                *neigh_hist.shape[:-1], CLASS_EMBED_DIM)], dim=-1)

        h_enc = drop(self.history_lstm(hist, hist_mask))
        # edge: sum-combine neighbour states over the slot axis
        combined = torch.where(neigh_mask[..., None, None], neigh_hist,
                               torch.zeros_like(neigh_hist)).sum(dim=-3)
        joint = torch.cat([combined, hist], dim=-1)
        e_enc = self.edge_lstm(joint, hist_mask)
        # dynamic-edge mask: zero influence when no neighbours at all
        e_enc = drop(e_enc * neigh_mask.any(dim=-1)[..., None])
        e_infl, _ = self.edge_attention(e_enc[..., None, :], h_enc)
        ctx = torch.cat([drop(e_infl), h_enc], dim=-1)
        if emb is not None:
            # the class shifts the context, so the denoiser sees it too
            ctx = ctx + self.class_film(emb)
        return ctx


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
        weights (..., heads, N, N), or None (every token attends)."""
        *lead, N, _ = x.shape
        shape = (*lead, N, self.n_heads, self.head_dim)
        q = self.query(x).view(shape) / math.sqrt(self.head_dim)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        w = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
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


class _PositionalTokens(nn.Module):
    """Holds the positional encoding of ``n`` tokens of width ``d`` as a
    buffer; longer sequences get theirs computed (the encoding of a
    position does not depend on the sequence's length)."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.register_buffer("pe", positional_encoding(n, d),
                             persistent=False)

    def forward(self, T: int):
        if T <= self.pe.shape[0]:
            return self.pe[:T]
        return positional_encoding(T, self.pe.shape[1]).to(self.pe.device)


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
        self.pos = _PositionalTokens(cfg.horizon, d)

    def forward(self, x, beta, context, scene_mask, generator=None):
        """x (*B, S, A, T, 2); beta (*B, S, A); context (*B, S, A, F);
        scene_mask (*B, A*T, A*T) bool, True = attend. One scene per
        leading index; the B axes (episodes) each have their own mask.
        ``generator`` draws the dropout masks in train mode."""
        *lead, A, T, _ = x.shape
        ctx = _time_context(beta, context)                  # (..., A, 1, 3+F)
        h = self.concat1(ctx, x) + self.pos(T)
        h = h.reshape(*lead, A * T, -1)
        # the mask broadcasts over the samples and the heads
        mask = scene_mask[..., None, None, :, :]
        for layer in self.tf:
            h = layer(h, mask, generator)
        h = h.reshape(*lead, A, T, -1)
        h = self.concat3(ctx, h)
        h = self.concat4(ctx, h)
        return self.linear(ctx, h)


class TransformerConcatLinear(nn.Module):
    """iMID denoiser: each agent on its own, its horizon as the tokens of
    an unmasked post-norm transformer between ConcatSquash layers."""

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
        self.pos = _PositionalTokens(cfg.horizon, d)

    def forward(self, x, beta, context, generator=None):
        """x (..., T, 2); beta (...); context (..., F): one sequence per
        leading index."""
        ctx = _time_context(beta, context)                  # (..., 1, 3+F)
        h = self.concat1(ctx, x) + self.pos(x.shape[-2])
        for layer in self.tf:
            h = layer(h, None, generator)
        h = self.concat3(ctx, h)
        h = self.concat4(ctx, h)
        return self.linear(ctx, h)


class TrajNet(nn.Module):
    """ConcatSquash MLP denoiser, pointwise over the horizon:
    2 -> 128 -> 256 -> 512 -> 256 -> 128 -> 2 with leaky ReLU between the
    layers, and the input added back with ``cfg.residual``."""
    WIDTHS = (128, 256, 512, 256, 128)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        ctx_dim = 3 + 2 * cfg.enc_rnn_dim
        widths = self.WIDTHS + (cfg.pred_dim,)
        ins = (cfg.pred_dim,) + widths[:-1]
        self.csl = nn.ModuleList(ConcatSquashLinear(i, ctx_dim, o)
                                 for i, o in zip(ins, widths))
        self.residual = cfg.residual

    def forward(self, x, beta, context, generator=None):
        ctx = _time_context(beta, context)
        h = x
        for i, layer in enumerate(self.csl):
            h = layer(ctx, h)
            if i < len(self.csl) - 1:
                h = nn.functional.leaky_relu(h)
        return x + h if self.residual else h


class TransformerLinear(nn.Module):
    """128-wide transformer denoiser (3 layers, 2 heads): the context,
    lifted to 128, rides as token 0 in front of the lifted horizon points
    and is dropped before the output layer."""
    WIDTH = 128

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        w = self.WIDTH
        self.ctx_up = nn.Linear(3 + 2 * cfg.enc_rnn_dim, w)
        self.y_up = nn.Linear(cfg.pred_dim, w)
        self.tf = nn.ModuleList(TransformerEncoderLayer(w, 2, 4 * w,
                                                        cfg.dropout)
                                for _ in range(3))
        self.linear = nn.Linear(w, cfg.pred_dim)
        self.pos = _PositionalTokens(cfg.horizon + 1, w)

    def forward(self, x, beta, context, generator=None):
        ctx = _time_context(beta, context)
        h = torch.cat([self.ctx_up(ctx), self.y_up(x)], dim=-2)
        h = h + self.pos(h.shape[-2])
        for layer in self.tf:
            h = layer(h, None, generator)
        return self.linear(h[..., 1:, :])


class _FlatMLP(nn.Module):
    """Shared body of SmallMLP and BigMLP: the whole horizon, the context
    and beta (a raw feature, no sin / cos) in one vector, mapped back to the
    horizon through dense layers with leaky ReLU."""

    def __init__(self, cfg: ModelConfig, widths):
        super().__init__()
        n = cfg.horizon * cfg.pred_dim
        ins = (n + 2 * cfg.enc_rnn_dim + 1,) + tuple(widths[:-1])
        self.layers = nn.ModuleList(nn.Linear(i, o)
                                    for i, o in zip(ins, widths))
        self.out = nn.Linear(widths[-1], n)

    def forward(self, x, beta, context, generator=None):
        *lead, T, D = x.shape
        h = torch.cat([x.reshape(*lead, T * D), context, beta[..., None]],
                      dim=-1)
        for layer in self.layers:
            h = nn.functional.leaky_relu(layer(h))
        return self.out(h).reshape(*lead, T, D)


class SmallMLP(nn.Module):
    """Three dense layers of 512."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mlp = _FlatMLP(cfg, (512, 512, 512))

    def forward(self, x, beta, context, generator=None):
        return self.mlp(x, beta, context)


class BigMLP(nn.Module):
    """512, nine of 1024, 512."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.mlp = _FlatMLP(cfg, (512,) + (1024,) * 9 + (512,))

    def forward(self, x, beta, context, generator=None):
        return self.mlp(x, beta, context)


class LinearDecoder(nn.Module):
    """Plain latent -> horizon decoder: in_dim -> 64 -> 128 -> 256 -> 512
    -> 256 -> 128 -> out_dim with leaky ReLU between."""
    WIDTHS = (64, 128, 256, 512, 256, 128)

    def __init__(self, out_dim: int = 12, in_dim: int = 32):
        super().__init__()
        ins = (in_dim,) + self.WIDTHS[:-1]
        self.layers = nn.ModuleList(nn.Linear(i, o)
                                    for i, o in zip(ins, self.WIDTHS))
        self.out = nn.Linear(self.WIDTHS[-1], out_dim)

    def forward(self, code):
        h = code
        for layer in self.layers:
            h = nn.functional.leaky_relu(layer(h))
        return self.out(h)


class JointInstanceTransformerConcatLinear(nn.Module):
    """Agent-token JMID denoisers (v1 / v2 / v3): each agent's embedded
    horizon is one token of width horizon * 2 * context_dim and attention
    runs across the scene's agents, with absent agents masked through the
    scene mask's agent blocks. v2 adds a two-layer MLP before the
    transformer, v3 one before and one after."""

    def __init__(self, cfg: ModelConfig, variant: int = 1):
        super().__init__()
        d = 2 * cfg.context_dim
        W = cfg.horizon * d
        ctx_dim = 3 + 2 * cfg.enc_rnn_dim
        self.variant = variant
        self.concat1 = ConcatSquashLinear(cfg.pred_dim, ctx_dim, d)
        self.pos = _PositionalTokens(cfg.horizon, d)
        if variant >= 2:
            self.mlp1_fc1 = nn.Linear(W, W)
            self.mlp1_fc2 = nn.Linear(W, W)
        self.tf = nn.ModuleList(
            TransformerEncoderLayer(W, cfg.n_heads, 4 * cfg.context_dim,
                                    cfg.dropout)
            for _ in range(cfg.tf_layer))
        if variant >= 3:
            self.mlp2_fc1 = nn.Linear(W, W)
            self.mlp2_fc2 = nn.Linear(W, W)
        self.concat3 = ConcatSquashLinear(d, ctx_dim, cfg.context_dim)
        self.concat4 = ConcatSquashLinear(cfg.context_dim, ctx_dim,
                                          cfg.context_dim // 2)
        self.linear = ConcatSquashLinear(cfg.context_dim // 2, ctx_dim,
                                         cfg.pred_dim)

    def forward(self, x, beta, context, scene_mask, generator=None):
        """Shapes as ``JointTransformerConcatLinear.forward``."""
        *lead, A, T, _ = x.shape
        ctx = _time_context(beta, context)
        h = self.concat1(ctx, x) + self.pos(T)
        flat = h.reshape(*lead, A, -1)                      # agents as tokens
        if self.variant >= 2:
            flat = self.mlp1_fc2(torch.relu(self.mlp1_fc1(flat)))
        # the agent blocks of the token mask, broadcast over samples, heads
        mask = scene_mask[..., ::T, ::T][..., None, None, :, :]
        for layer in self.tf:
            flat = layer(flat, mask, generator)
        if self.variant >= 3:
            flat = self.mlp2_fc2(torch.relu(self.mlp2_fc1(flat)))
        h = flat.reshape(*lead, A, T, -1)
        h = self.concat3(ctx, h)
        h = self.concat4(ctx, h)
        return self.linear(ctx, h)


# the reference's config.diffnet names -> (constructor, joint?)
DIFFNETS = {
    "TransformerConcatLinear": (TransformerConcatLinear, False),
    "TrajNet": (TrajNet, False),
    "TransformerLinear": (TransformerLinear, False),
    "SmallMLP": (SmallMLP, False),
    "BigMLP": (BigMLP, False),
    "JointPredictionTransformerConcatLinear":
        (JointTransformerConcatLinear, True),
    "JointPredictionInstanceTransformerConcatLinear":
        (lambda cfg: JointInstanceTransformerConcatLinear(cfg, 1), True),
    "JointPredictionInstanceTransformerConcatLinearv2":
        (lambda cfg: JointInstanceTransformerConcatLinear(cfg, 2), True),
    "JointPredictionInstanceTransformerConcatLinearv3":
        (lambda cfg: JointInstanceTransformerConcatLinear(cfg, 3), True),
}


def make_denoiser(cfg: ModelConfig, joint: bool):
    """cfg.diffnet, or the mode's default (JMID's joint transformer, iMID's
    TransformerConcatLinear), as (module, is_joint)."""
    name = cfg.diffnet or ("JointPredictionTransformerConcatLinear" if joint
                           else "TransformerConcatLinear")
    ctor, is_joint = DIFFNETS[name]
    return ctor(cfg), is_joint


def init_parameters(module: nn.Module, generator=None):
    """Flax's initializers in place: ``lecun_normal`` dense and conv
    kernels (a normal cut at two standard deviations, std
    sqrt(1 / fan_in) / 0.8796), embeddings the same with fan_in their
    width, orthogonal recurrent kernels per gate (LSTM and GRU), zero
    biases, LayerNorm scale 1 and bias 0; drawn from ``generator``, a CPU
    generator."""
    def draw(param, init, **kw):
        # drawn on the CPU, so one seed gives one model on every device
        x = torch.empty(param.shape)
        init(x, generator=generator, **kw)
        param.copy_(x)

    def lecun(param, fan_in):
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        draw(param, nn.init.trunc_normal_, std=std, a=-2 * std, b=2 * std)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun(m.weight, m.in_features)
            elif isinstance(m, nn.Conv2d):
                lecun(m.weight, m.weight[0].numel())
            elif isinstance(m, nn.Embedding):
                lecun(m.weight, m.embedding_dim)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
            if isinstance(m, (nn.Linear, nn.Conv2d, LayerNorm)) and \
                    m.bias is not None:
                m.bias.zero_()
        for m in module.modules():
            if isinstance(m, LSTMEncoder):
                for gate in m.w_h.weight.split(m.hidden):
                    draw(gate, nn.init.orthogonal_)
            for kernel in getattr(m, "recurrent_kernels", lambda: ())():
                draw(kernel, nn.init.orthogonal_)


def standardize_history(hist_raw, current_pos):
    """(..., T, 6) raw [pos, vel, acc] -> standardized: positions relative
    to ``current_pos`` over the attention radius; vel/2; acc/1."""
    rel_pos = hist_raw[..., 0:2] - current_pos[..., None, :]
    return torch.cat([rel_pos / ATTENTION_RADIUS, hist_raw[..., 2:4] / 2.0,
                      hist_raw[..., 4:6] / 1.0], dim=-1)


def integrate_velocity_samples(vel, p0, dt):
    """Single-integrator integration: positions = p0 + cumsum(vel) * dt."""
    return p0[..., None, :] + torch.cumsum(vel, dim=-2) * dt

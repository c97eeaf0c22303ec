"""SARL and RGL value networks as ``nn.Module``s (twin of
``sicnav_tpu/rl/networks.py``).

SARL embeds each human with an MLP, pools the embeddings by attention
against their masked mean and scores the robot's state with the pooled
crowd; RGL runs a two-layer relational GCN with embedded-gaussian
similarity over the robot and human nodes. Both read the same robocentric,
un-rotated features (``input_transformation``) and mask padded human
slots exactly as the reference does.

Layers follow the reference's Flax modules so that ``convert.py`` can load
its parameters: an ``MLP`` keeps its ``Dense`` layers in ``layers`` (Flax's
``Dense_i``), and RGL's ``w_a``, ``w1`` and ``w2`` are raw parameters.
Inputs are (..., 9) robot states, (..., H, 5) human states and (..., H)
masks on any leading axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion.models import init_parameters


@dataclasses.dataclass(frozen=True)
class SARLConfig:
    """[sarl] of the reference's sarl_policy.config."""
    mlp1_dims: Sequence[int] = (150, 100)
    mlp2_dims: Sequence[int] = (100, 50)
    attention_dims: Sequence[int] = (100, 100, 1)
    mlp3_dims: Sequence[int] = (150, 100, 100, 1)
    with_global_state: bool = True
    self_state_dim: int = 6
    human_state_dim: int = 7


@dataclasses.dataclass(frozen=True)
class RGLConfig:
    """[rgl] of the reference's rgl_policy.config."""
    num_layer: int = 2
    X_dim: int = 32
    wr_dims: Sequence[int] = (64, 32)
    wh_dims: Sequence[int] = (64, 32)
    final_state_dim: int = 32
    gcn2_w1_dim: int = 32
    planning_dims: Sequence[int] = (150, 100, 100, 1)
    similarity_function: str = "embedded_gaussian"
    layerwise_graph: bool = True
    skip_connection: bool = False
    self_state_dim: int = 6
    human_state_dim: int = 7


class MLP(nn.Module):
    """Dense layers with a ReLU between them (and after the last one when
    ``last_relu``)."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 last_relu: bool = False):
        super().__init__()
        sizes = [in_dim, *dims]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(sizes[:-1], sizes[1:]))
        self.last_relu = last_relu

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.last_relu:
                x = torch.relu(x)
        return x


def input_transformation(robot_state, human_states):
    """Robocentric (un-rotated) features.

    robot_state: (..., 9) [px, py, vx, vy, r, gx, gy, v_pref, theta]
    human_states: (..., H, 5) [px, py, vx, vy, r]
    Returns (..., H, 13): [dx, dy, v_pref, radius, vx, vy,
                           px1, py1, vx1, vy1, radius1, da, radius_sum].
    """
    r = robot_state[..., None, :]
    px1 = human_states[..., 0] - r[..., 0]
    py1 = human_states[..., 1] - r[..., 1]
    da = torch.sqrt(px1 ** 2 + py1 ** 2)
    radius_sum = r[..., 4] + human_states[..., 4]
    rf = torch.stack([r[..., 5] - r[..., 0], r[..., 6] - r[..., 1],
                      r[..., 7], r[..., 4], r[..., 2], r[..., 3]], dim=-1)
    rf = rf.expand(*human_states.shape[:-1], 6)
    hf = torch.stack([px1, py1, human_states[..., 2], human_states[..., 3],
                      human_states[..., 4], da, radius_sum], dim=-1)
    return torch.cat([rf, hf], dim=-1)


class SARLNetwork(nn.Module):
    """V(robot_state, human_states, human_mask) with attention pooling.
    Lives on ``device`` (CUDA unless named); fresh parameters are Flax's
    initializers drawn from ``seed``."""

    def __init__(self, cfg: SARLConfig = SARLConfig(), device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        d_in = cfg.self_state_dim + cfg.human_state_dim
        self.mlp1 = MLP(d_in, cfg.mlp1_dims, last_relu=True)
        self.mlp2 = MLP(cfg.mlp1_dims[-1], cfg.mlp2_dims)
        attn_in = cfg.mlp1_dims[-1] * (2 if cfg.with_global_state else 1)
        self.attention = MLP(attn_in, cfg.attention_dims)
        self.mlp3 = MLP(cfg.mlp2_dims[-1] + cfg.self_state_dim, cfg.mlp3_dims)
        init_parameters(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, robot_state, human_states, human_mask):
        state = input_transformation(robot_state, human_states)
        self_state = state[..., 0, :self.cfg.self_state_dim]
        e = self.mlp1(state)
        h = self.mlp2(e)
        if self.cfg.with_global_state:
            w = human_mask[..., None].to(e.dtype)
            global_state = (e * w).sum(dim=-2, keepdim=True) / torch.clamp(
                w.sum(dim=-2, keepdim=True), min=1.0)
            attn_in = torch.cat([e, global_state.expand_as(e)], dim=-1)
        else:
            attn_in = e
        scores = self.attention(attn_in)[..., 0]
        scores = scores - torch.where(human_mask, scores, math.inf).amin(
            dim=-1, keepdim=True)
        scores = torch.clamp(scores, max=50.0)
        scores = torch.where(human_mask, scores, -1e9)
        weights = torch.softmax(scores, dim=-1)
        pooled = (weights[..., None] * h).sum(dim=-2)
        joint = torch.cat([self_state, pooled], dim=-1)
        return self.mlp3(joint)[..., 0]


class RGLNetwork(nn.Module):
    """Relational GCN value network. Lives on ``device`` (CUDA unless
    named); fresh parameters are Flax's initializers drawn from ``seed``:
    lecun-normal Dense kernels, and ``w_a``, ``w1``, ``w2`` from
    normal(1 / sqrt(X_dim)), as the reference scales them."""

    def __init__(self, cfg: RGLConfig = RGLConfig(), device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.w_r = MLP(cfg.self_state_dim, cfg.wr_dims, last_relu=True)
        self.w_h = MLP(cfg.human_state_dim, cfg.wh_dims, last_relu=True)
        w1_out = cfg.gcn2_w1_dim if cfg.num_layer == 2 else cfg.final_state_dim
        self.w_a = nn.Parameter(torch.empty(cfg.X_dim, cfg.X_dim))
        self.w1 = nn.Parameter(torch.empty(cfg.X_dim, w1_out))
        if cfg.num_layer == 2:
            self.w2 = nn.Parameter(torch.empty(cfg.gcn2_w1_dim,
                                               cfg.final_state_dim))
        self.value_net = MLP(cfg.final_state_dim, cfg.planning_dims)
        gen = torch.Generator().manual_seed(seed)
        init_parameters(self, gen)
        with torch.no_grad():
            for name in ("w_a", "w1", "w2"):
                if hasattr(self, name):
                    getattr(self, name).normal_(
                        0.0, 1.0 / math.sqrt(cfg.X_dim), generator=gen)
        self.to(resolve_device(device))

    def _similarity(self, X, mask):
        if self.cfg.similarity_function == "embedded_gaussian":
            A = X @ self.w_a @ X.transpose(-1, -2)
        elif self.cfg.similarity_function == "gaussian":
            A = X @ X.transpose(-1, -2)
        else:
            raise NotImplementedError(self.cfg.similarity_function)
        A = torch.where(mask[..., None, :], A, -1e9)
        return torch.softmax(A, dim=-1)

    def forward(self, robot_state, human_states, human_mask):
        cfg = self.cfg
        state = input_transformation(robot_state, human_states)
        self_state = state[..., 0, :cfg.self_state_dim]
        hum_feats = state[..., cfg.self_state_dim:]
        r_emb = self.w_r(self_state)
        h_emb = self.w_h(hum_feats)
        X = torch.cat([r_emb[..., None, :], h_emb], dim=-2)
        node_mask = torch.cat([torch.ones_like(human_mask[..., :1]),
                               human_mask], dim=-1)
        A = self._similarity(X, node_mask)
        h1 = torch.relu(A @ X @ self.w1)
        if cfg.skip_connection:
            h1 = h1 + X
        if cfg.num_layer == 2:
            A2 = self._similarity(h1, node_mask) if cfg.layerwise_graph else A
            h2 = torch.relu(A2 @ h1 @ self.w2)
            if cfg.skip_connection:
                h2 = h2 + h1
            feat = h2[..., 0, :]
        else:
            feat = h1[..., 0, :]
        return self.value_net(feat)[..., 0]


def make_network(name: str, device=None, seed: int = 0) -> nn.Module:
    """The value network a policy name stands for, at the published
    widths: ``"sarl"`` or ``"rgl"``."""
    if name == "sarl":
        return SARLNetwork(device=device, seed=seed)
    if name == "rgl":
        return RGLNetwork(device=device, seed=seed)
    raise ValueError(name)

"""Scene data for the JMID predictor (twin of
``sicnav_tpu/diffusion/data.py``).

Only what the forecaster needs is ported in this slice: the attention
radius, the finite-difference derivative and the ``SceneBatch`` record.
Dataset construction for training comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ATTENTION_RADIUS = 3.0


def derivative_of(x, dt):
    """Finite-difference derivative over the last axis with the first
    element repeated."""
    if x.shape[-1] < 2:
        return torch.zeros_like(x)
    dx = torch.diff(x, dim=-1) / dt
    return torch.cat([dx[..., :1], dx], dim=-1)


class SceneBatch(NamedTuple):
    """One scene at one prediction timestep (tensors).

    hist: (A, T_h, 6) raw [px, py, vx, vy, ax, ay]
    hist_mask: (A, T_h) frames that exist
    fut_vel: (A, T_f, 2) raw future velocities (diffusion target)
    fut_mask: (A, T_f)
    agent_mask: (A,) agents present at the prediction time
    neighbor_mask: (A, A) [target, neighbour] adjacency (attention radius)
    node_type: (A,) int class codes; None = all pedestrians
    """
    hist: torch.Tensor
    hist_mask: torch.Tensor
    fut_vel: torch.Tensor
    fut_mask: torch.Tensor
    agent_mask: torch.Tensor
    neighbor_mask: torch.Tensor
    node_type: torch.Tensor = None

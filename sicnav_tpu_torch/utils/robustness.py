"""Robustness evaluation: seeded observation-noise injection (twin of
``sicnav_tpu/utils/robustness.py``).

The policy observes human positions and velocities perturbed by Gaussian
noise while the simulator evolves the true state: the controller's
sensitivity to perception error.

The reference folds its key from ``state.step_idx`` alone, and its harness
maps the policy over episodes that all start at step 0, so every episode
of a batch sees the same draw at a given step. The port keeps that
structure: a draw is a function of ``(cfg.seed, step_idx)`` only, made by a
``torch.Generator`` seeded from both, once for each distinct ``step_idx`` of
a batch and broadcast over the episodes at that step. JAX's PRNG values
cannot be reproduced in torch, so parity tests hand the reference's draws
in (``perturb_observation(..., draws=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sicnav_tpu_torch.env.types import SimState


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    pos_std: float = 0.05
    vel_std: float = 0.05
    seed: int = 0


def step_draws(state: SimState, cfg: NoiseConfig):
    """Two standard-normal draws shaped like ``h_pos`` and ``h_vel``: for
    each distinct ``step_idx`` of the (possibly batched) state, one draw
    from a generator on the state's device seeded from ``(cfg.seed,
    step_idx)``, shared by the episodes at that step. Reads the step
    counters on the host."""
    dev = state.h_pos.device
    per_episode = tuple(state.h_pos.shape[-2:])
    steps = state.step_idx
    lead = (1,) * steps.dim()
    noise = torch.zeros((2,) + tuple(state.h_pos.shape), device=dev)
    for step in torch.unique(steps).tolist():
        seed = int(np.random.SeedSequence([cfg.seed, int(step)])
                   .generate_state(1)[0])
        g = torch.Generator(device=dev).manual_seed(seed)
        draw = torch.randn((2,) + per_episode, generator=g, device=dev)
        at = (steps == step)[..., None, None]
        noise = torch.where(at, draw.reshape((2,) + lead + per_episode),
                            noise)
    return noise[0], noise[1]


def perturb_observation(state: SimState, cfg: NoiseConfig,
                        draws=None) -> SimState:
    """A copy of the state with noisy human observations (the true state is
    untouched; feed the copy to the policy only). ``draws``: the two
    standard-normal tensors shaped like ``h_pos`` and ``h_vel``; drawn by
    ``step_draws`` when not handed in."""
    if draws is None:
        draws = step_draws(state, cfg)
    d_pos, d_vel = draws
    return state._replace(h_pos=state.h_pos + cfg.pos_std * d_pos,
                          h_vel=state.h_vel + cfg.vel_std * d_vel)


def noisy_policy(policy_fn, cfg: NoiseConfig):
    """Wrap a stateless policy ``policy_fn(state) -> action`` so that it
    sees perturbed observations."""
    def wrapped(state: SimState):
        return policy_fn(perturb_observation(state, cfg))
    return wrapped


def noisy_policy_stateful(step_fn, cfg: NoiseConfig):
    """Carry-state variant for CAMPC and SICNav-Diffusion: ``step_fn(state,
    carry) -> (action, carry, ...)``; the wrapper has the same signature
    and perturbs only what the policy observes."""
    def wrapped(state: SimState, carry):
        return step_fn(perturb_observation(state, cfg), carry)
    return wrapped

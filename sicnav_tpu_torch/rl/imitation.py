"""Imitation-learning bootstrap: ORCA demonstrations -> value regression
(twin of ``sicnav_tpu/rl/imitation.py``).

ORCA drives a holonomic robot through a batch of device resets; every
visited state of a successful episode is labelled with its discounted
reward-to-go, and the value network is fitted to the labels by MSE with
SGD and momentum after a global-norm clip.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion.mid import clip_by_global_norm_
from sicnav_tpu_torch.env import crowd_sim, rollout
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.policies.orca_robot import orca_robot_action


@dataclasses.dataclass(frozen=True)
class ILConfig:
    """[imitation_learning] of the reference's sarl_policy.config."""
    il_episodes: int = 300
    il_epochs: int = 100
    il_learning_rate: float = 0.01
    momentum: float = 0.9
    gamma: float = 0.9
    safety_space: float = 0.15
    batch_size: int = 100


def discounted_reward_to_go(rewards, live, adj_gamma):
    """Per-visited-state labels: value_i = sum_{t>=i} adj_gamma^(t-i) * r_t
    over live steps. rewards, live: (..., T). The reverse recurrence
    acc = r_t + adj_gamma * acc in float32, in the reference's order."""
    r = torch.where(live, rewards, 0.0)
    g = float(np.float32(adj_gamma))
    acc = torch.zeros_like(r[..., 0])
    vals = []
    for t in reversed(range(r.shape[-1])):
        acc = r[..., t] + g * acc
        vals.append(acc)
    return torch.stack(vals[::-1], dim=-1)


def collect_demonstrations(env_cfg: EnvConfig, il: ILConfig, seed: int = 0,
                           n_episodes: int = None, max_steps: int = None,
                           device=None, generator=None, draws=None):
    """Batched ORCA rollouts of a holonomic robot (safety space
    ``il.safety_space``) from ``n_episodes`` device resets, each visited
    state labelled with its full discounted reward-to-go
    sum_{t>=i} gamma^((t-i) dt v_pref) r_t, successful episodes only.
    Resets draw from ``generator`` (one on ``device`` seeded with ``seed``
    by default) or take the handed-in ``draws``.

    Returns tensors on ``device`` (CUDA unless named): robot (N, 9),
    humans (N, H, 5), hmask (N, H), values (N,)."""
    device = resolve_device(device)
    n_episodes = n_episodes or il.il_episodes
    max_steps = max_steps or int(env_cfg.time_limit / env_cfg.dt) + 2
    cfg = dataclasses.replace(env_cfg, robot_kinematics="holonomic")
    if generator is None and draws is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    states = crowd_sim.reset_device(cfg, n_episodes, generator, device, draws)

    def pol(s):
        return orca_robot_action(s, cfg, safety_space=il.safety_space)

    _, stats, traj = rollout.batch_rollout(states, pol, cfg, max_steps)
    # traj holds the states after each step; the state visited at step t is
    # the reset for t = 0 and traj[t - 1] after. Each step's reward comes
    # from replaying the deterministic policy and env step on the visited
    # states, all (B, T) of them in one call.
    pre = crowd_sim.tree_map(
        lambda s0, tr: torch.cat([s0[:, None], tr[:, :-1]], dim=1),
        states, traj)
    _, rewards, _ = crowd_sim.step_masked(pre, pol(pre), cfg)      # (B, T)
    live = ~pre.done

    adj_gamma = il.gamma ** (cfg.dt * cfg.robot_v_pref)
    values = discounted_reward_to_go(rewards, live, adj_gamma)
    # the reference keeps the states of successful episodes only
    keep = live & stats.success[:, None]
    return (crowd_sim.robot_full_state(pre)[keep],
            crowd_sim.observable_human_states(pre)[0][keep],
            pre.h_mask[keep], values[keep])


def fit_value_net(net, data, il: ILConfig = ILConfig(), seed: int = 0,
                  init_params=None, generator=None, perms=None):
    """MSE regression of ``net`` (in place) to the demonstrations' values:
    minibatches of ``il.batch_size`` in a fresh permutation each epoch (the
    last partial batch dropped), a global-norm clip at 1.0 (optax's: no
    epsilon) and SGD with momentum (torch's first step equals optax's
    trace). Permutations come from ``generator`` (one on the net's device
    seeded with ``seed`` by default), or one per epoch from ``perms``.
    Returns (the net's state_dict, the mean loss of each epoch)."""
    robot, humans, hmask, values = data
    dev = next(net.parameters()).device
    if init_params is not None:
        net.load_state_dict(init_params)
    if generator is None and perms is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.SGD(net.parameters(), lr=il.il_learning_rate,
                          momentum=il.momentum)
    N, bs = robot.shape[0], il.batch_size
    losses = []
    for epoch in range(il.il_epochs):
        perm = (torch.as_tensor(perms[epoch], device=dev) if perms is not None
                else torch.randperm(N, generator=generator, device=dev))
        ep = []
        for i in range(0, N - bs + 1, bs):
            idx = perm[i:i + bs]
            opt.zero_grad(set_to_none=True)
            pred = net(robot[idx], humans[idx], hmask[idx])
            loss = torch.mean((pred - values[idx]) ** 2)
            loss.backward()
            clip_by_global_norm_(list(net.parameters()), 1.0)
            opt.step()
            ep.append(loss.detach())
        losses.append(torch.stack(ep).double().mean().item() if ep
                      else math.nan)
    return net.state_dict(), losses

"""DQN over vectorized crowd-nav environments (twin of
``sicnav_tpu/rl/dqn.py``).

The value network scores every discrete action by a one-step lookahead:
one human-policy evaluation per state, then the A robot branches stepped
as one batch on a new action axis (the reference ``vmap``s the branches).
States carry leading environment axes, so B environments and their A
branches are one (B, A) batch, and their B x H humans go through the ORCA
LP as one call.

Rollout collection (epsilon-greedy, auto-reset from fresh device draws),
the replay buffer on the device, target-network updates and the
fitted-value train step follow the reference. The collect step reads the
device once, in the ORCA LP (``ops/orca.solve_orca_lp``): the robot's env
step reuses the lookahead's human actions, fresh resets copy nothing from
the host (``crowd_sim.reset_device(base=...)``), and the buffer's write
position and size are host integers, pure functions of the step count.
The training loop reads the device only every ``log_every`` steps.

Random draws come from a ``torch.Generator`` or are handed in (``draws``),
so the tests can give the port the reference's draws.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.env import crowd_sim, scenarios
from sicnav_tpu_torch.env.crowd_sim import (
    observable_human_states, robot_full_state, step_with_human_actions,
    tree_map,
)
from sicnav_tpu_torch.env.human_policies import human_actions
from sicnav_tpu_torch.env.types import EnvConfig, SimState
from sicnav_tpu_torch.parallel.mesh import (
    all_mean, all_mean_grads, gather_batch, replicate, shard_batch,
)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Defaults = the reference's sarl_policy.config [rl]/[train]."""
    gamma: float = 0.9
    lr: float = 5e-4
    total_timesteps: int = 200_000
    buffer_capacity: int = 100_000
    batch_size: int = 100
    target_update_interval: int = 50
    eps_start: float = 0.5
    eps_end: float = 0.1
    eps_decay: int = 4000
    # the discrete action space
    speed_samples: int = 5
    rotation_samples: int = 6
    rotation_bound_per_second: float = 180.0
    learning_starts: int = 1000


def build_action_space(cfg: EnvConfig, dqn: DQNConfig,
                       device=None) -> torch.Tensor:
    """(A, 2) discrete (v, r) actions: the null action, then for each of
    the linspace rotations the exp-spaced speeds. On ``device`` (CUDA
    unless named)."""
    v_pref = cfg.robot_v_pref
    n_s, n_r = dqn.speed_samples, dqn.rotation_samples
    speeds = [(np.exp((i + 1) / n_s) - 1) / (np.e - 1) * v_pref
              for i in range(n_s)]
    bound = dqn.rotation_bound_per_second * cfg.dt * np.pi / 180.0
    rotations = np.linspace(-bound, bound, n_r, endpoint=False)
    actions = [(0.0, 0.0)]
    for r in rotations:
        for s in speeds:
            actions.append((s, r))
    return torch.as_tensor(np.array(actions, np.float32),
                           device=resolve_device(device))


def _branches(x, k: int, A: int):
    """x with a new axis of A after its first k (leading) axes."""
    return x.unsqueeze(k).expand(*x.shape[:k], A, *x.shape[k:])


def _step_branches(state: SimState, actions, h_act, cfg: EnvConfig):
    """Every state of the batch stepped with each of the A actions and its
    own human actions: results on the leading axes (..., A)."""
    A = actions.shape[0]
    k = state.t.dim()
    branch = tree_map(lambda x: _branches(x, k, A), state)
    return step_with_human_actions(
        branch, actions.expand(*state.t.shape, A, 2),
        _branches(h_act, k, A), cfg)


def lookahead(state: SimState, actions, cfg: EnvConfig, h_act=None):
    """Evaluate every discrete action: one human-policy evaluation (or the
    handed-in ``h_act`` of this state), then the A robot branches.

    Returns (robot_states (..., A, 9), human_states (..., A, H, 5),
    rewards (..., A), dones (..., A)) for the state's leading axes."""
    if h_act is None:
        h_act = human_actions(state, cfg)
    s2, rew, info = _step_branches(state, actions, h_act, cfg)
    return (robot_full_state(s2), observable_human_states(s2)[0], rew,
            info.done)


def lookahead2(state: SimState, actions, cfg: EnvConfig):
    """Two-step lookahead: for every pair of discrete actions (a, b), the
    state and reward after playing a then b, with the humans' actions
    evaluated again on each first-step state.

    Returns (robot_states (..., A, A, 9), human_states (..., A, A, H, 5),
    rewards1 (..., A), rewards2 (..., A, A), done1 (..., A))."""
    s1, rew1, info1 = _step_branches(state, actions,
                                     human_actions(state, cfg), cfg)
    s2, rew2, _ = _step_branches(s1, actions, human_actions(s1, cfg), cfg)
    return (robot_full_state(s2), observable_human_states(s2)[0], rew1, rew2,
            info1.done)


def _adj_gamma(env_cfg: EnvConfig, dqn: DQNConfig) -> float:
    return dqn.gamma ** (env_cfg.dt * env_cfg.robot_v_pref)


def make_q_fn(net, env_cfg: EnvConfig, dqn: DQNConfig, actions):
    """``q_values(state, h_act=None) -> (..., A)``:
    Q(s, a) = r_a + gamma^(dt * v_pref) * V(s'_a), V from ``net``'s
    current parameters; 0 in place of V where the branch ends."""
    adj_gamma = _adj_gamma(env_cfg, dqn)

    def q_values(state: SimState, h_act=None):
        rs, hs, rew, done = lookahead(state, actions, env_cfg, h_act)
        hmask = _branches(state.h_mask, state.t.dim(), actions.shape[0])
        v = net(rs, hs, hmask)
        return rew + adj_gamma * torch.where(done, 0.0, v)

    return q_values


def make_q2_fn(net, env_cfg: EnvConfig, dqn: DQNConfig, actions):
    """Two-step Q: Q(s, a) = r_a + g * max_b [r_ab + g * V(s''_ab)], the
    max left out where a ends the episode."""
    adj_gamma = _adj_gamma(env_cfg, dqn)

    def q_values(state: SimState):
        rs2, hs2, rew1, rew2, done1 = lookahead2(state, actions, env_cfg)
        A = actions.shape[0]
        k = state.t.dim()
        hmask = _branches(_branches(state.h_mask, k, A), k + 1, A)
        v2 = net(rs2, hs2, hmask)                          # (..., A, A)
        q2 = rew2 + adj_gamma * v2
        return rew1 + adj_gamma * torch.where(done1, 0.0,
                                              q2.amax(dim=-1))

    return q_values


def greedy_policy(net, env_cfg: EnvConfig, dqn: DQNConfig, actions,
                  record=None):
    """``policy(states) -> (..., 2)``: the action of the largest Q of each
    state (the first one on a tie), without gradients. With ``record``, a
    list, each call appends its Q-values (..., A)."""
    q_fn = make_q_fn(net, env_cfg, dqn, actions)

    def policy(states):
        with torch.no_grad():
            q = q_fn(states)
        if record is not None:
            record.append(q)
        return actions[q.argmax(dim=-1)]

    return policy


class Transition(NamedTuple):
    robot: torch.Tensor       # (..., 9)
    humans: torch.Tensor      # (..., H, 5)
    hmask: torch.Tensor       # (..., H)
    next_robot: torch.Tensor
    next_humans: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class ReplayBuffer(NamedTuple):
    """Transitions stacked on a leading capacity axis on the device; the
    write position ``idx`` and the fill ``size`` are host integers."""
    data: Transition
    idx: int
    size: int

    @staticmethod
    def create(capacity: int, H: int, device=None) -> "ReplayBuffer":
        device = resolve_device(device)

        def z(*shape, dtype=torch.float32):
            return torch.zeros((capacity,) + shape, dtype=dtype,
                               device=device)

        data = Transition(z(9), z(H, 5), z(H, dtype=torch.bool), z(9),
                          z(H, 5), z(), z(dtype=torch.bool))
        return ReplayBuffer(data, 0, 0)


def buffer_add(buf: ReplayBuffer, batch: Transition, n: int) -> ReplayBuffer:
    """Write a batch of n transitions at the ring's position, in place.
    Reads nothing from the device."""
    cap = buf.data.reward.shape[0]
    locs = torch.arange(buf.idx, buf.idx + n,
                        device=buf.data.reward.device) % cap
    for d, b in zip(buf.data, batch):
        d.index_copy_(0, locs, b.to(d.dtype))
    return ReplayBuffer(buf.data, (buf.idx + n) % cap,
                        min(buf.size + n, cap))


def buffer_sample(buf: ReplayBuffer, batch_size: int, generator=None,
                  idx=None) -> Transition:
    """``batch_size`` transitions drawn uniformly, with replacement, from
    the filled part (indices from ``generator``, or handed in as
    ``idx``)."""
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,),
                            generator=generator,
                            device=buf.data.reward.device)
    return Transition(*[d.index_select(0, idx) for d in buf.data])


def epsilon(step: int, dqn: DQNConfig) -> float:
    """The exploration rate at ``step``: linear from eps_start to eps_end
    over eps_decay steps, in float32 as the reference computes it."""
    f32 = np.float32
    frac = np.clip(f32(step / dqn.eps_decay), f32(0.0), f32(1.0))
    return float(f32(dqn.eps_start) +
                 frac * f32(dqn.eps_end - dqn.eps_start))


def train_step(net, target, optimizer, batch: Transition,
               gamma: float, mesh=None) -> torch.Tensor:
    """Fitted value iteration: V(s) <- r + (1 - done) * gamma * V_target(s'),
    the mean squared error and one step of ``optimizer`` (Adam in
    ``train``). Returns the loss, a 0-d tensor on the device (not
    synchronized).

    With ``mesh`` each rank holds its equal share of the batch and the same
    parameters: the gradients and the loss are averaged over the ranks
    before Adam, which gives every rank the whole batch's step."""
    with torch.no_grad():
        v_next = target(batch.next_robot, batch.next_humans, batch.hmask)
        tgt = batch.reward + (1.0 - batch.done.to(v_next.dtype)) * gamma * \
            v_next
    optimizer.zero_grad(set_to_none=True)
    v = net(batch.robot, batch.humans, batch.hmask)
    loss = torch.mean((v - tgt) ** 2)
    loss.backward()
    if mesh is not None:
        all_mean_grads(net.parameters(), mesh)
        loss = all_mean(loss, mesh)
    optimizer.step()
    return loss.detach()


def make_optimizer(net, dqn: DQNConfig):
    """optax's ``adam(lr)``: betas 0.9 / 0.999, eps 1e-8 outside the
    square root."""
    return torch.optim.Adam(net.parameters(), lr=dqn.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def collect_draws(env_cfg: EnvConfig, n_envs: int, n_actions: int,
                  generator=None, device=None):
    """The draws of one collect step: (explore uniforms (B,), random action
    indices (B,), the resets' ``scenarios.device_draws``)."""
    return (torch.rand((n_envs,), generator=generator, device=device),
            torch.randint(0, n_actions, (n_envs,), generator=generator,
                          device=device),
            scenarios.device_draws(env_cfg, n_envs, generator, device))


def _tree_where(cond, a, b):
    """Leafwise ``torch.where`` with ``cond`` on the leading axes."""
    return tree_map(lambda x, y: torch.where(
        cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y),
        a, b)


def make_collect_step(net, env_cfg: EnvConfig, dqn: DQNConfig, actions,
                      base: SimState = None):
    """One vectorized env step with epsilon-greedy action selection:
    ``collect(states, global_step, generator=None, draws=None) ->
    (new_states, Transition batch, StepInfo)``. Finished environments
    restart from fresh resets, drawn for every environment and selected
    where done (as the reference does: drawing for the finished ones alone
    would read ``done`` on the host). ``base`` is a fresh ``reset_device``
    of the same B environments for those resets (one is made at the first
    call otherwise)."""
    q_fn = make_q_fn(net, env_cfg, dqn, actions)
    bases = {} if base is None else {base.t.shape[0]: base}

    def collect(states: SimState, global_step: int, generator=None,
                draws=None):
        B = states.t.shape[0]
        dev = states.t.device
        if B not in bases:
            bases[B] = crowd_sim.reset_device(
                env_cfg, B, torch.Generator(device=dev).manual_seed(0), dev)
        if draws is None:
            draws = collect_draws(env_cfg, B, actions.shape[0], generator,
                                  dev)
        u_eps, rand, reset_draws = draws
        h_act = human_actions(states, env_cfg)
        with torch.no_grad():
            q = q_fn(states, h_act)                          # (B, A)
        explore = u_eps < epsilon(global_step, dqn)
        act = actions[torch.where(explore, rand, q.argmax(dim=-1))]

        new_states, rew, info = step_with_human_actions(states, act, h_act,
                                                        env_cfg)
        trans = Transition(robot_full_state(states),
                           observable_human_states(states)[0], states.h_mask,
                           robot_full_state(new_states),
                           observable_human_states(new_states)[0], rew,
                           info.done)
        fresh = crowd_sim.reset_device(env_cfg, B, draws=reset_draws,
                                       base=bases[B])
        return _tree_where(info.done, fresh, new_states), trans, info

    return collect


class EpisodeRates(NamedTuple):
    """Per-env episodic event counters and rolling sums over completed
    episodes (the reference CustomCallback's per-episode Collision /
    Frozen / Danger rates and its ReachGoal / Timeout rates)."""
    steps: torch.Tensor       # (B,) steps in the running episode
    coll: torch.Tensor        # (B,) event steps in the running episode
    wall: torch.Tensor
    frozen: torch.Tensor
    danger: torch.Tensor
    ep_count: torch.Tensor    # () completed episodes since the last log
    reach: torch.Tensor       # () completed with ReachGoal
    timeout: torch.Tensor     # () completed with Timeout
    rate_coll: torch.Tensor   # () sum of per-episode step fractions
    rate_wall: torch.Tensor
    rate_frozen: torch.Tensor
    rate_danger: torch.Tensor


def init_episode_rates(n_envs: int, device=None) -> EpisodeRates:
    device = resolve_device(device)
    z = torch.zeros((n_envs,), device=device)
    return EpisodeRates(z, z, z, z, z, *[torch.zeros((), device=device)
                                         for _ in range(7)])


def update_episode_rates(acc: EpisodeRates, info) -> EpisodeRates:
    steps = acc.steps + 1.0
    coll = acc.coll + info.collision
    wall = acc.wall + info.wall_collision
    frozen = acc.frozen + info.frozen
    danger = acc.danger + info.danger
    done = info.done

    def fin(ev):
        return torch.where(done, ev / steps, 0.0).sum()

    def reset(x):
        return torch.where(done, 0.0, x)

    return EpisodeRates(
        steps=reset(steps), coll=reset(coll), wall=reset(wall),
        frozen=reset(frozen), danger=reset(danger),
        ep_count=acc.ep_count + done.sum(),
        reach=acc.reach + (done & info.reach_goal).sum(),
        timeout=acc.timeout + (done & info.timeout).sum(),
        rate_coll=acc.rate_coll + fin(coll),
        rate_wall=acc.rate_wall + fin(wall),
        rate_frozen=acc.rate_frozen + fin(frozen),
        rate_danger=acc.rate_danger + fin(danger))


def episode_rates_record(acc: EpisodeRates) -> dict:
    """The window's rates as floats (one read of the device)."""
    ep, reach, timeout, coll, wall, frozen, danger = torch.stack(
        list(acc[5:])).tolist()
    n = max(ep, 1.0)
    return {
        "episodes": ep,
        "reach_goal_rate": reach / n,
        "timeout_rate": timeout / n,
        "collision_rate": coll / n,
        "wall_collision_rate": wall / n,
        "frozen_rate": frozen / n,
        "danger_rate": danger / n,
    }


def train(net, env_cfg: EnvConfig, dqn: DQNConfig = DQNConfig(),
          n_envs: int = 32, seed: int = 0, total_steps: int = None,
          init_params=None, log_every: int = 200, log_dir: str = None,
          tensorboard: bool = False, mesh=None, save_freq: int = 0,
          checkpoint_dir: str = None, device=None, generator=None):
    """The DQN training loop; trains ``net`` in place and returns (its
    state_dict, the metrics history).

    ``init_params`` (a state_dict) is loaded first; without it training
    starts from the net's own parameters. Environments and exploration
    draw from ``generator``, or from one on ``device`` seeded with
    ``seed``. ``log_dir`` streams the history as JSONL
    (``utils/metrics.MetricsLogger``), with tensorboard files when
    ``tensorboard``. ``save_freq`` > 0 with ``checkpoint_dir`` saves the
    parameters, the target, Adam's state and the full replay buffer every
    save_freq env steps (``save_train_checkpoint``).

    ``mesh`` (``parallel.mesh.Mesh``, called in every rank of a
    ``parallel.mesh.launch``): data-parallel training on the mesh's
    devices. Each rank steps its rows of the ``n_envs`` environments
    (``n_envs`` divides over the ranks) and every rank draws the same
    global random numbers from the same seed and keeps its rows, so the
    run is the unsharded one. The transitions are gathered after each
    collect, so every rank holds the whole replay buffer and samples the
    same indices; where ``batch_size`` divides over the ranks each rank
    trains on its rows and the gradients are averaged
    (``train_step(mesh=)``), else every rank computes the whole batch.
    The parameters start from rank 0's; the target copies rank 0's; the
    log and the checkpoints are rank 0's. Every rank returns the same."""
    if mesh is not None:
        device = mesh.device
        if n_envs % mesh.size:
            raise ValueError(f"dqn.train: {n_envs} environments do not "
                             f"divide over {mesh.size} ranks")
    device = resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    logger = None
    if log_dir is not None and lead:
        from sicnav_tpu_torch.utils.metrics import MetricsLogger
        logger = MetricsLogger(log_dir, "dqn", tensorboard=tensorboard)
    net.to(device)
    if init_params is not None:
        net.load_state_dict(init_params)
    if mesh is not None:
        replicate(net.state_dict(), mesh)
    shard_train = mesh is not None and dqn.batch_size % mesh.size == 0
    target = copy.deepcopy(net).requires_grad_(False)
    optimizer = make_optimizer(net, dqn)
    actions = build_action_space(env_cfg, dqn, device)

    states = shard_batch(crowd_sim.reset_device(env_cfg, n_envs, generator,
                                                device), mesh)
    buf = ReplayBuffer.create(dqn.buffer_capacity, env_cfg.max_humans,
                              device)
    collect = make_collect_step(net, env_cfg, dqn, actions, base=states)

    total = total_steps or dqn.total_timesteps
    history = []
    step_count = 0
    ep_rates = init_episode_rates(n_envs, device)
    while step_count < total:
        draws = shard_batch(collect_draws(env_cfg, n_envs, actions.shape[0],
                                          generator, device), mesh)
        states, trans, info = collect(states, step_count, draws=draws)
        trans, info = gather_batch((trans, info), mesh)
        buf = buffer_add(buf, trans, n_envs)
        ep_rates = update_episode_rates(ep_rates, info)
        step_count += n_envs

        if step_count > dqn.learning_starts:
            batch = buffer_sample(buf, dqn.batch_size, generator)
            if shard_train:
                loss = train_step(net, target, optimizer,
                                  shard_batch(batch, mesh), dqn.gamma, mesh)
            else:
                loss = train_step(net, target, optimizer, batch, dqn.gamma)
            if (step_count // n_envs) % dqn.target_update_interval == 0:
                target.load_state_dict(
                    net.state_dict() if mesh is None else
                    replicate(copy.deepcopy(net.state_dict()), mesh))
            if (step_count // n_envs) % log_every == 0:
                loss_v, reward_mean, done_rate = torch.stack([
                    loss, trans.reward.mean(),
                    trans.done.float().mean()]).tolist()
                rec = {"step": step_count, "loss": loss_v,
                       "eps": epsilon(step_count, dqn),
                       "reward_mean": reward_mean, "done_rate": done_rate}
                rec.update(episode_rates_record(ep_rates))
                # the window restarts; running episodes keep their counts
                ep_rates = init_episode_rates(n_envs, device)._replace(
                    steps=ep_rates.steps, coll=ep_rates.coll,
                    wall=ep_rates.wall, frozen=ep_rates.frozen,
                    danger=ep_rates.danger)
                history.append(rec)
                if logger is not None:
                    logger.log(**rec)
        if (save_freq and checkpoint_dir and lead and
                step_count % max(save_freq - save_freq % n_envs, n_envs) == 0):
            save_train_checkpoint(checkpoint_dir, step_count, net.state_dict(),
                                  target.state_dict(), optimizer.state_dict(),
                                  buf)
    if save_freq and checkpoint_dir and lead:
        save_train_checkpoint(checkpoint_dir, step_count, net.state_dict(),
                              target.state_dict(), optimizer.state_dict(), buf)
    if logger is not None:
        logger.close()
    return net.state_dict(), history


CHECKPOINT_FILE = "train_state.pt"


def save_train_checkpoint(path, step, params, target_params, opt_state,
                          buf: ReplayBuffer):
    """Persist the full training state: the net's and the target's
    state_dicts, the optimizer's state_dict and the whole replay buffer,
    written atomically to ``<path>/train_state.pt``."""
    os.makedirs(path, exist_ok=True)
    state = dict(step=int(step), params=params, target_params=target_params,
                 opt_state=opt_state,
                 buffer=dict(data=buf.data._asdict(), idx=buf.idx,
                             size=buf.size))
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def load_train_checkpoint(path, device=None):
    """Returns (step, params, target_params, opt_state, ReplayBuffer), the
    parameters and the buffer on ``device`` (CUDA unless named). The
    optimizer's state stays on the CPU: ``load_state_dict`` moves its
    moments to the parameters' device and keeps Adam's step counts on the
    host, where reading them costs no wait for the card."""
    device = resolve_device(device)
    st = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                    weights_only=True)

    def to_dev(sd):
        return {k: v.to(device) for k, v in sd.items()}

    b = st["buffer"]
    buf = ReplayBuffer(Transition(**{k: v.to(device)
                                     for k, v in b["data"].items()}),
                       b["idx"], b["size"])
    return (st["step"], to_dev(st["params"]), to_dev(st["target_params"]),
            st["opt_state"], buf)


def train_on_mesh(mesh, model: str, env_cfg: EnvConfig, dqn: DQNConfig,
                  n_envs: int, seed: int = 0, total_steps: int = None,
                  log_every: int = 200, init_params=None):
    """A rank body for ``parallel.mesh.launch``: ``train`` of a fresh
    ``model`` network ("sarl" or "rgl", drawn from ``seed``, then
    ``init_params`` if given) on ``mesh``. Returns (state_dict, history),
    the same on every rank."""
    from sicnav_tpu_torch.rl.networks import make_network
    net = make_network(model, device=mesh.device, seed=seed)
    return train(net, env_cfg, dqn, n_envs=n_envs, seed=seed,
                 total_steps=total_steps, init_params=init_params,
                 log_every=log_every, mesh=mesh)

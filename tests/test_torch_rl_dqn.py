"""Parity of the port's DQN (sicnav_tpu_torch.rl.dqn) with the JAX
reference (sicnav_tpu.rl.dqn).

- Every public function and class of the reference's three RL modules
  has its twin in the port.
- The discrete action space: exactly the reference's array.
- ``lookahead`` and ``lookahead2`` on ORCA and linear humans, the port's
  on a batch of states at once, each held to the reference's per state:
  states and rewards 1e-5, dones equal (``tests/test_torch_env.py``'s
  tolerance for env steps).
- ``make_q_fn`` with the shipped ``sarl_200k`` weights at the full 31
  actions: 1e-5 of the largest |Q|.
- The replay buffer's ring and sampling with the reference's indices:
  exact.
- Three ``train_step``s against optax's Adam: loss and parameters 1e-5;
  SARL's last attention bias, whose gradient is rounding alone (the
  softmax cancels it), only within 3 lr of its start on both sides.
- One collect step with the reference's draws (explore uniforms, random
  actions, the resets' uniforms), two environments timing out so that
  their fresh resets are selected: Q-values 1e-5; chosen actions equal
  wherever the step explores or the top two Q-values differ by more than
  1e-4 (a nearer tie is rounding's to decide, and must pick a near-best
  action); states, transitions and infos 1e-5 where the choices agree.
- ``EpisodeRates`` on the reference test's event sequence: equal records.
- The training checkpoint's round trip, bit-equal; a 120-step ``train`` at
  four environments, its losses finite and its rates within [0, 1].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.rl import dqn as D_ref
from sicnav_tpu.rl import networks as N_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import types as T
from sicnav_tpu_torch.rl import dqn as D
from sicnav_tpu_torch.rl import networks as N

from tests.test_torch_env import assert_tree_close, port_cfg, to_torch
from tests.test_torch_rl_networks import (
    SOFTMAX_SHIFTS, checkpoint_params, ref_params,
)
from tests.test_torch_scenarios_device import batch_draws

torch.set_num_threads(2)
TOL = 1e-5
TIE = 1e-4
ENV = T_ref.EnvConfig(scenario="circle_crossing", human_policy="orca",
                      human_num=3, max_humans=3, starts_moving=0,
                      robot_kinematics="unicycle")
DQN = D_ref.DQNConfig(buffer_capacity=500, learning_starts=32, eps_decay=100)
SMALL = D_ref.DQNConfig(speed_samples=2, rotation_samples=2)


def port_dqn(dqn):
    return D.DQNConfig(**dataclasses.asdict(dqn))


def sarl(params):
    net = N.SARLNetwork(device="cpu")
    net.load_state_dict(convert.sarl_state_dict(
        jax.tree.map(np.asarray, params)))
    return net


def ref_states(cfg_ref, cases):
    return [CS_ref.reset_host(cfg_ref, c) for c in cases]


def stack_ref(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["networks", "dqn", "imitation"])
def test_public_names_match_reference(name):
    """Every public function and class of the reference module has its
    twin in the port."""
    import ast
    import importlib
    import pathlib
    ref = pathlib.Path(__file__).resolve().parent.parent / "sicnav_tpu" / \
        "rl" / f"{name}.py"
    public = {n.name for n in ast.parse(ref.read_text()).body
              if isinstance(n, (ast.FunctionDef, ast.ClassDef))
              and not n.name.startswith("_")}
    port = importlib.import_module(f"sicnav_tpu_torch.rl.{name}")
    assert public and not {n for n in public if not hasattr(port, n)}


def test_action_space_exact():
    for dqn in (D_ref.DQNConfig(), SMALL):
        want = np.asarray(D_ref.build_action_space(ENV, dqn))
        got = D.build_action_space(port_cfg(ENV), port_dqn(dqn), "cpu")
        assert got.dtype == torch.float32 and want.shape == (
            1 + dqn.speed_samples * dqn.rotation_samples, 2)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", ["orca", "linear"])
def test_lookahead(policy):
    cfg_ref = dataclasses.replace(ENV, human_policy=policy)
    cfg = port_cfg(cfg_ref)
    actions = D_ref.build_action_space(cfg_ref, D_ref.DQNConfig())
    states = ref_states(cfg_ref, [0, 4])
    look = jax.jit(D_ref.lookahead, static_argnames="cfg")
    got = D.lookahead(to_torch(stack_ref(states)),
                      torch.as_tensor(np.array(actions)), cfg)
    assert got[0].shape == (2, 31, 9) and got[1].shape == (2, 31, 3, 5)
    for i, s in enumerate(states):
        for g, w in zip(got, look(s, actions, cfg_ref)):
            _close(g[i], w)


@pytest.mark.parametrize("policy", ["orca", "linear"])
def test_lookahead2(policy):
    cfg_ref = dataclasses.replace(ENV, human_policy=policy, human_num=2,
                                  max_humans=2)
    cfg = port_cfg(cfg_ref)
    actions = D_ref.build_action_space(cfg_ref, SMALL)
    A = actions.shape[0]
    states = ref_states(cfg_ref, [0, 2])
    look2 = jax.jit(D_ref.lookahead2, static_argnames="cfg")
    got = D.lookahead2(to_torch(stack_ref(states)),
                       torch.as_tensor(np.array(actions)), cfg)
    assert got[0].shape == (2, A, A, 9) and got[3].shape == (2, A, A)
    for i, s in enumerate(states):
        for g, w in zip(got, look2(s, actions, cfg_ref)):
            _close(g[i], w)


def test_q_values_with_sarl_200k():
    params = checkpoint_params("sarl")
    cfg = port_cfg(ENV)
    actions = D_ref.build_action_space(ENV, D_ref.DQNConfig())
    q_ref = jax.jit(D_ref.make_q_fn(N_ref.SARLNetwork(), ENV,
                                    D_ref.DQNConfig(), actions))
    states = ref_states(ENV, [0, 1, 2])
    q_fn = D.make_q_fn(sarl(params), cfg, D.DQNConfig(),
                       torch.as_tensor(np.array(actions)))
    with torch.no_grad():
        got = q_fn(to_torch(stack_ref(states)))
    assert got.shape == (3, 31)
    for i, s in enumerate(states):
        want = np.asarray(q_ref(params, s))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=TOL * max(np.abs(want).max(), 1.0))


def _transitions(n, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return (f(n, 9), f(n, H, 5), rng.uniform(size=(n, H)) < 0.8, f(n, 9),
            f(n, H, 5), f(n), rng.uniform(size=n) < 0.3)


def test_replay_buffer_ring_and_sample():
    buf_ref = D_ref.ReplayBuffer.create(8, 3)
    buf = D.ReplayBuffer.create(8, 3, "cpu")
    for seed in range(3):                        # the third add wraps
        t = _transitions(4, 3, seed)
        buf_ref = D_ref.buffer_add(buf_ref, D_ref.Transition(
            *map(jnp.asarray, t)), 4)
        buf = D.buffer_add(buf, D.Transition(*map(torch.as_tensor, t)), 4)
        assert (buf.idx, buf.size) == (int(buf_ref.idx), int(buf_ref.size))
    assert buf.size == 8 and buf.idx == 4
    for g, w in zip(buf.data, buf_ref.data):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    key = jax.random.PRNGKey(3)
    want = D_ref.buffer_sample(buf_ref, key, 16)
    idx = jax.random.randint(key, (16,), 0, 8)
    got = D.buffer_sample(buf, 16, idx=torch.as_tensor(np.asarray(idx),
                                                       dtype=torch.long))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    own = D.buffer_sample(buf, 16, torch.Generator().manual_seed(0))
    assert own.reward.shape == (16,)


def test_three_train_steps_match_optax():
    H = 3
    params = ref_params("sarl", seed=7, H=H)
    target = ref_params("sarl", seed=8, H=H)
    ref = N_ref.SARLNetwork()
    tx = optax.adam(DQN.lr)
    opt_state = tx.init(params)
    net, tgt = sarl(params), sarl(target)
    start = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params)["params"]))
    opt = D.make_optimizer(net, port_dqn(DQN))
    for seed in range(3):
        t = _transitions(32, H, 10 + seed)
        t = t[:1] + (np.abs(t[1]) + 0.3,) + t[2:]
        params, opt_state, loss_ref = D_ref.train_step(
            ref, tx, params, target, opt_state,
            D_ref.Transition(*map(jnp.asarray, t)), DQN.gamma)
        loss = D.train_step(net, tgt, opt,
                            D.Transition(*map(torch.as_tensor, t)), DQN.gamma)
        np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=TOL)
        got = dict(jax.tree_util.tree_leaves_with_path(
            convert.rl_flax_params(net.state_dict())["params"]))
        want = jax.tree.map(np.asarray, params)["params"]
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            if jax.tree_util.keystr(path) in SOFTMAX_SHIFTS:
                # its gradient is rounding (the softmax cancels it), which
                # Adam steps by up to lr on either side
                for side in (got[path], w):
                    assert np.abs(side - start[path]).max() <= 3 * DQN.lr
                continue
            np.testing.assert_allclose(got[path], w, rtol=0, atol=TOL,
                                       err_msg=jax.tree_util.keystr(path))


def test_epsilon_schedule():
    for step in (0, 1, 50, 99, 100, 5000):
        assert D.epsilon(step, port_dqn(DQN)) == float(
            D_ref.epsilon(step, DQN))


def reference_collect_draws(key, cfg_ref, B, A):
    """The draws the reference's collect step makes from ``key``."""
    k_eps, k_act, k_reset = jax.random.split(key, 3)
    u = jax.random.uniform(k_eps, (B,))
    rand = jax.random.randint(k_act, (B,), 0, A)
    return (torch.as_tensor(np.asarray(u)),
            torch.as_tensor(np.asarray(rand), dtype=torch.long),
            batch_draws(jax.random.split(k_reset, B), cfg_ref))


def test_collect_step_with_the_reference_draws():
    B, step = 6, 50                               # eps 0.3 at step 50
    params = ref_params("sarl", seed=2, H=3)
    actions = D_ref.build_action_space(ENV, DQN)
    A = actions.shape[0]
    states_ref = stack_ref(ref_states(ENV, range(B)))
    # two environments at their time limit: they end and restart
    t = np.zeros(B, np.float32)
    t[[1, 4]] = ENV.time_limit
    states_ref = states_ref._replace(t=jnp.asarray(t))
    key = jax.random.PRNGKey(11)
    collect_ref = D_ref.make_collect_step(N_ref.SARLNetwork(), ENV, DQN,
                                          actions)
    new_ref, trans_ref, info_ref = collect_ref(params, states_ref, key, step)
    assert np.asarray(info_ref.done).sum() == 2

    net = sarl(params)
    cfg = port_cfg(ENV)
    acts = torch.as_tensor(np.array(actions))
    collect = D.make_collect_step(net, cfg, port_dqn(DQN), acts)
    draws = reference_collect_draws(key, ENV, B, A)
    new, trans, info = collect(to_torch(states_ref), step, draws=draws)

    # the greedy choice is held where the top two Q-values are apart
    q_ref = np.asarray(jax.vmap(lambda s: D_ref.make_q_fn(
        N_ref.SARLNetwork(), ENV, DQN, actions)(params, s))(states_ref))
    with torch.no_grad():
        q = D.make_q_fn(net, cfg, port_dqn(DQN), acts)(to_torch(states_ref))
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=0, atol=TOL)
    top2 = np.sort(q_ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > TIE
    explore = np.asarray(draws[0]) < D.epsilon(step, port_dqn(DQN))
    assert explore.any() and (~explore & decided).any()
    rand = np.asarray(draws[1])
    chose_ref = np.where(explore, rand, q_ref.argmax(-1))
    chose = np.where(explore, rand, q.numpy().argmax(-1))
    held = decided | explore
    np.testing.assert_array_equal(chose[held], chose_ref[held])
    # a near tie may go either way, but to a near-best action
    assert (q_ref.max(-1) - q_ref[np.arange(B), chose] <= TIE).all()
    same = torch.as_tensor(chose == chose_ref)
    assert int(same.sum()) >= B - 1

    def rows(tree):
        return CS.tree_map(lambda x: x[same], tree)

    ref_rows = jax.tree.map(lambda x: np.asarray(x)[same.numpy()],
                            (trans_ref, info_ref, new_ref))
    for g, w in zip((trans, info, new), ref_rows):
        assert_tree_close(rows(g), w)


def _info(coll, done, reach):
    z = torch.zeros(2)
    b = lambda v: torch.tensor(v)
    return T.StepInfo(
        reach_goal=b(reach), timeout=b(done) & ~b(reach), collision=b(coll),
        wall_collision=b([False, False]), frozen=b([False, False]),
        danger=b(coll), dmin=z, r_success=z, r_timeout=z, r_collision=z,
        r_wall=z, r_danger=z, r_progress=z, r_freezing=z, r_angular=z,
        r_linear=z, total_reward=z, done=b(done))


def test_episode_rates():
    """The reference test's sequence: env 0 collides on steps 1 and 2 of 4
    and reaches its goal; env 1 runs on. Then a second window."""
    seq = [([True, False], [False, False], [False, False]),
           ([True, False], [False, False], [False, False]),
           ([False, False], [False, False], [False, False]),
           ([False, True], [True, False], [True, False]),
           ([False, True], [False, True], [False, False])]
    acc_ref = D_ref.init_episode_rates(2)
    acc = D.init_episode_rates(2, "cpu")
    for ev in seq:
        i = _info(*ev)
        acc = D.update_episode_rates(acc, i)
        acc_ref = D_ref.update_episode_rates(
            acc_ref, jax.tree.map(lambda x: jnp.asarray(x.numpy()), i))
        assert D.episode_rates_record(acc) == pytest.approx(
            D_ref.episode_rates_record(acc_ref), abs=1e-7)
    rec = D.episode_rates_record(acc)
    # env 0: 2 collision steps of 4; env 1: 2 of 5
    assert rec["episodes"] == 2.0
    assert rec["collision_rate"] == pytest.approx((0.5 + 0.4) / 2)


def test_train_checkpoint_round_trip(tmp_path):
    cfg = port_cfg(dataclasses.replace(ENV, human_num=2, max_humans=2))
    dqn = D.DQNConfig(learning_starts=16, batch_size=16, buffer_capacity=512)
    net = N.SARLNetwork(device="cpu", seed=1)
    params, _ = D.train(net, cfg, dqn, n_envs=8, seed=1, total_steps=64,
                        save_freq=32, checkpoint_dir=str(tmp_path),
                        device="cpu")
    step, p2, tp2, opt2, buf = D.load_train_checkpoint(str(tmp_path), "cpu")
    assert step == 64
    for k, v in params.items():
        assert torch.equal(v, p2[k]), k
    assert buf.size == 64 and buf.data.robot.shape[0] == 512
    # the reloaded state resumes: Adam's moments and counts load bit-equal
    again = N.SARLNetwork(device="cpu")
    again.load_state_dict(p2)
    opt = D.make_optimizer(again, dqn)
    opt.load_state_dict(opt2)
    D.save_train_checkpoint(str(tmp_path / "again"), step, p2, tp2,
                            opt.state_dict(), buf)
    st = torch.load(tmp_path / "again" / D.CHECKPOINT_FILE,
                    weights_only=True)
    first = torch.load(tmp_path / D.CHECKPOINT_FILE, weights_only=True)
    a, b = _flat(first), _flat(st)
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _flat(tree, prefix=""):
    """{path: numpy array or value} of nested dicts, lists and tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree.numpy() if torch.is_tensor(tree) else tree}


def test_short_train_run(tmp_path):
    """The reference's short run at four environments: every logged loss
    finite, every CustomCallback rate within [0, 1], the JSONL stream
    written."""
    net = N.SARLNetwork(device="cpu")
    params, hist = D.train(net, port_cfg(ENV), port_dqn(DQN), n_envs=4,
                           total_steps=120, log_every=2,
                           log_dir=str(tmp_path), device="cpu")
    assert len(hist) == 11
    for h in hist:
        assert np.isfinite(h["loss"])
        for k in ("collision_rate", "frozen_rate", "danger_rate",
                  "reach_goal_rate", "timeout_rate", "wall_collision_rate"):
            assert 0.0 <= h[k] <= 1.0, (k, h)
    assert all(torch.isfinite(v).all() for v in params.values())
    assert (tmp_path / "dqn.jsonl").read_text().count("\n") == len(hist)

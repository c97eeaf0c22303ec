"""Batched episodes in the port's environment and rollouts
(sicnav_tpu_torch.env.crowd_sim.reset_batch / step_masked on a leading
episode axis, sicnav_tpu_torch.env.rollout.batch_rollout and
rollout_episode_traced) against the JAX reference's vmapped ones.

Tolerances: states and rewards of single steps 1e-5 absolute, as
tests/test_torch_env.py holds one episode (the same float32 operations on
both sides); booleans and integers equal. Over an 18-step DWA rollout the
rounding accumulates: float episode statistics (nav_time, min_dist, the
summed reward), trajectories and traces 1e-4; integer statistics and
boolean trace fields exact.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import rollout as RO_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.policies import dwa as D_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import rollout as RO
from sicnav_tpu_torch.policies import dwa as D

from tests.test_torch_env import assert_tree_close, port_cfg

torch.set_num_threads(2)
CASES = [0, 3, 7]
# the definitive protocol's env, and the shipped defaults (3 humans in 8
# slots starting over 10 steps), cut to a short episode
PROTOCOL = T_ref.EnvConfig(scenario="hallway_bottleneck",
                           human_policy="orca_plus", human_num=3,
                           max_humans=3, starts_moving=0, time_limit=30,
                           robot_kinematics="unicycle")
SHORT = dataclasses.replace(PROTOCOL, time_limit=4.0)


def _stack_ref(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _lead(tree, i):
    return CS.tree_map(lambda x: x[i], tree)


def _assert_stats(got, want):
    for name in RO.EpisodeStats._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("cfg_ref", [PROTOCOL, T_ref.EnvConfig()],
                         ids=["protocol", "defaults"])
def test_batched_reset_and_step_match_vmapped_reference(cfg_ref):
    cfg = port_cfg(cfg_ref)
    s_ref = _stack_ref([CS_ref.reset_host(cfg_ref, c) for c in CASES])
    s = CS.reset_batch(cfg, CASES, device="cpu")
    assert_tree_close(s, s_ref)
    step_ref = jax.jit(jax.vmap(lambda st, a: CS_ref.step_masked(st, a,
                                                                 cfg_ref)))
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = np.stack([rng.uniform(0.0, 1.0, len(CASES)),
                      rng.uniform(-0.25, 0.25, len(CASES))],
                     -1).astype(np.float32)
        s_ref, r_ref, info_ref = step_ref(s_ref, jnp.asarray(a))
        s, r, info = CS.step_masked(s, torch.as_tensor(a), cfg)
        assert_tree_close(s, s_ref)
        assert_tree_close(info, info_ref)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0,
                                   atol=1e-5)


def test_batched_step_equals_one_episode_steps():
    """A batch is the episodes stepped one by one (the port against
    itself, exactly: no op mixes episodes)."""
    cfg = port_cfg(T_ref.EnvConfig(human_num=5))
    s = CS.reset_batch(cfg, CASES, device="cpu")
    singles = [CS.reset_host(cfg, c, device="cpu") for c in CASES]
    for _ in range(4):
        a = D.dwa_policy_batch(s, cfg)
        s, r, _ = CS.step_masked(s, a, cfg)
        for i, one in enumerate(singles):
            a_i = D.dwa_policy(one, cfg)
            torch.testing.assert_close(a[i], a_i, rtol=0, atol=0)
            singles[i], r_i, _ = CS.step_masked(one, a_i, cfg)
            torch.testing.assert_close(r[i], r_i, rtol=0, atol=0)
            for name, x, y in zip(s._fields, _lead(s, i), singles[i]):
                if name != "door":
                    torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_batch_rollout_dwa_matches_reference():
    cfg = port_cfg(SHORT)
    max_steps = int(SHORT.time_limit / SHORT.dt) + 2
    s_ref = _stack_ref([CS_ref.reset_host(SHORT, c) for c in CASES])
    final_ref, stats_ref, traj_ref = RO_ref.batch_rollout(
        s_ref, lambda st: D_ref.dwa_policy(st, SHORT), SHORT, max_steps)
    s = CS.reset_batch(cfg, CASES, device="cpu")
    final, stats, traj = RO.batch_rollout(
        s, lambda st: D.dwa_policy_batch(st, cfg), cfg, max_steps)
    _assert_stats(stats, stats_ref)
    assert traj.r_pos.shape == (len(CASES), max_steps, 2)
    np.testing.assert_allclose(traj.r_pos.numpy(), np.asarray(traj_ref.r_pos),
                               rtol=0, atol=1e-4)
    assert_tree_close(final, final_ref, tol=1e-4)
    assert int(stats.steps.sum()) > 0


class _Carry(NamedTuple):
    door_latch: object
    door_stall: object


class _Aux(NamedTuple):
    speed: object
    stall: object


def _cheap_step(dwa, lib):
    """A stateful policy with the carry fields the rollout reads: DWA acts,
    the latch engages on every third step, the stall counter counts."""
    def step_fn(state, carry):
        action = dwa(state)
        stall = carry.door_stall + 1
        latch = stall % 3 == 0
        aux = _Aux(speed=lib.abs(action[..., 0]), stall=stall)
        return action, _Carry(door_latch=latch, door_stall=stall), aux
    return step_fn


def test_traced_rollout_matches_vmapped_reference():
    cfg = port_cfg(SHORT)
    max_steps = int(SHORT.time_limit / SHORT.dt) + 2
    n = len(CASES)
    s_ref = _stack_ref([CS_ref.reset_host(SHORT, c) for c in CASES])
    c_ref = _Carry(jnp.zeros(n, bool), jnp.zeros(n, jnp.int32))
    step_ref = _cheap_step(lambda st: D_ref.dwa_policy(st, SHORT), jnp)
    _, stats_ref, tr_ref = jax.vmap(
        lambda st, c: RO_ref.rollout_episode_traced(
            st, c, step_ref, SHORT, max_steps))(s_ref, c_ref)

    s = CS.reset_batch(cfg, CASES, device="cpu")
    c = _Carry(torch.zeros(n, dtype=torch.bool),
               torch.zeros(n, dtype=torch.int32))
    step_fn = _cheap_step(lambda st: D.dwa_policy_batch(st, cfg), torch)
    _, stats, tr = RO.rollout_episode_traced(s, c, step_fn, cfg, max_steps)

    _assert_stats(stats, stats_ref)
    assert int(stats.yield_steps.sum()) > 0
    for name in RO.StepTrace._fields:
        got, want = getattr(tr, name), getattr(tr_ref, name)
        if name == "aux":
            assert type(got) is _Aux
            assert_tree_close(got, want, tol=1e-4)
            continue
        g, w = got.numpy(), np.asarray(want)
        assert g.shape == w.shape == (n, max_steps) + w.shape[2:], name
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)


def test_one_episode_traced_rollout_keeps_its_layout():
    """Without an episode axis the trace is (T, ...), as the reference's
    unbatched traced rollout."""
    cfg = port_cfg(SHORT)
    s = CS.reset_host(cfg, 0, device="cpu")
    c = _Carry(torch.zeros((), dtype=torch.bool),
               torch.zeros((), dtype=torch.int32))
    step_fn = _cheap_step(lambda st: D.dwa_policy(st, cfg), torch)
    _, stats, tr = RO.rollout_episode_traced(s, c, step_fn, cfg, 5)
    assert tr.r_pos.shape == (5, 2) and tr.h_pos.shape == (5, 3, 2)
    assert tr.aux.speed.shape == (5,) and stats.steps.shape == ()
    assert tr.door_stall.tolist() == [1, 2, 3, 4, 5]

"""Parity of the port's environment (sicnav_tpu_torch.env) with the JAX
reference (sicnav_tpu.env): walls, wall clamping, scenario generation,
ORCA-plus humans, reset, masked stepping and the stateful rollout.

The port runs on the CPU. Tolerance 1e-5 absolute on positions,
velocities, times and rewards: both sides do the same float32 operations;
XLA and PyTorch round transcendentals and reductions differently by a few
ulp, and 20 steps of integration keep that well under 1e-5 on values of
order 1. Booleans and integers must be equal. A human's heading is the
angle of its velocity, so a velocity error e turns it by e / |v|: headings
are held to the same 1e-5 on |v| * angle error.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import human_policies as HP_ref
from sicnav_tpu.env import rollout as RO_ref
from sicnav_tpu.env import scenarios as SC_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.env import wall_clamp as WC_ref
from sicnav_tpu.env import walls as W_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import human_policies as HP
from sicnav_tpu_torch.env import rollout as RO
from sicnav_tpu_torch.env import scenarios as SC
from sicnav_tpu_torch.env import types as T
from sicnav_tpu_torch.env import wall_clamp as WC
from sicnav_tpu_torch.env import walls as W

torch.set_num_threads(2)
TOL = 1e-5


def port_cfg(cfg_ref):
    """The port's EnvConfig with the same fields as a reference config."""
    fields = dataclasses.asdict(cfg_ref)
    fields["rewards"] = T.RewardConfig(**fields["rewards"])
    return T.EnvConfig(**fields)


def to_torch(tree):
    return CS.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


def assert_tree_close(got, want, tol=TOL):
    for name, g, w in zip(want._fields, got, want):
        if hasattr(w, "_fields"):
            assert_tree_close(g, w, tol)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "h_theta":
            turn = np.angle(np.exp(1j * (g.astype(np.float64) - w)))
            speed = np.linalg.norm(np.asarray(want.h_vel), axis=-1)
            np.testing.assert_array_less(np.abs(turn) * speed, tol,
                                         err_msg=name)
        elif w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_config_defaults_match():
    assert dataclasses.asdict(T.EnvConfig()) == dataclasses.asdict(T_ref.EnvConfig())
    assert T.EnvConfig().n_walls == T_ref.EnvConfig().n_walls


@pytest.mark.parametrize("scenario", ["hallway_bottleneck", "hallway_static",
                                      "hallway_squeeze", "rectangle",
                                      "circle_crossing"])
def test_build_walls(scenario):
    cfg_ref = T_ref.EnvConfig(scenario=scenario)
    want = W_ref.build_walls(cfg_ref)
    got = W.build_walls(port_cfg(cfg_ref))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        assert g == w


@pytest.mark.parametrize("scenario,human_num", [
    ("hallway_bottleneck", 3), ("hallway_bottleneck", 8),
    ("circle_crossing", 5), ("square_crossing", 4)])
def test_generate_host_identical(scenario, human_num):
    cfg_ref = T_ref.EnvConfig(scenario=scenario, human_num=human_num)
    cfg = port_cfg(cfg_ref)
    walls, wmask, _ = W_ref.build_walls(cfg_ref)
    for case in range(4):
        want = SC_ref.generate_host(cfg_ref, case, "test", walls, wmask)
        got = SC.generate_host(cfg, case, "test", walls, wmask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_wall_clamp(seed):
    rng = np.random.default_rng(seed)
    cfg_ref = T_ref.EnvConfig(scenario="hallway_static")
    walls, wmask, _ = W_ref.build_walls(cfg_ref)
    n = 256
    pos = rng.uniform([-1.2, -2.5], [1.2, 2.5], (n, 2)).astype(np.float32)
    act = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    rad = np.full(n, 0.3, np.float32)
    want = jax.vmap(WC_ref.clamp_holonomic_action,
                    in_axes=(0, 0, 0, None, None, None))(
        pos, act, rad, 0.25, walls, wmask)
    got = WC.clamp_holonomic_action(*map(torch.as_tensor, (pos, act, rad)),
                                    0.25, torch.as_tensor(walls),
                                    torch.as_tensor(wmask))
    assert np.asarray(want[1]).sum() > 10            # some actions clamped
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    theta = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    v, r = act[:, 0], act[:, 1] * 0.2
    want = jax.vmap(WC_ref.clamp_unicycle_action,
                    in_axes=(0, 0, 0, 0, 0, None, None, None))(
        pos, theta, v, r, rad, 0.25, walls, wmask)
    got = WC.clamp_unicycle_action(*map(torch.as_tensor, (pos, theta, v, r,
                                                          rad)),
                                   0.25, torch.as_tensor(walls),
                                   torch.as_tensor(wmask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


CASES = [(3, 0), (3, 5), (8, 1)]        # (human_num, case)


@pytest.mark.parametrize("human_num,case", CASES)
def test_reset_host(human_num, case):
    cfg_ref = T_ref.EnvConfig(human_num=human_num)
    want = CS_ref.reset_host(cfg_ref, case)
    got = CS.reset_host(port_cfg(cfg_ref), case, device="cpu")
    assert_tree_close(got, want)


@pytest.mark.parametrize("policy", ["orca", "orca_plus"])
def test_human_actions(policy):
    cfg_ref = T_ref.EnvConfig(human_num=8, human_policy=policy)
    state = CS_ref.reset_host(cfg_ref, 2)
    want = HP_ref.human_actions(state, cfg_ref)
    got = HP.human_actions(to_torch(state), port_cfg(cfg_ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _sfm_cfg(scenario, robot_visible):
    return T_ref.EnvConfig(scenario=scenario, human_policy="sfm",
                           human_num=5, max_humans=6,
                           robot_visible=robot_visible)


def _near_walls(state):
    """The reset moved so that every human stands within 0.5 m of a wall
    (and of the robot), where the wall and agent pushes are large."""
    walls = np.asarray(state.walls)[np.asarray(state.wall_mask)]
    rng = np.random.default_rng(0)
    H = state.h_pos.shape[0]
    w = walls[rng.integers(0, len(walls), H)]
    u = rng.uniform(0.2, 0.8, (H, 1))
    pts = w[:, 0] + u * (w[:, 1] - w[:, 0])
    normal = np.stack([-(w[:, 1, 1] - w[:, 0, 1]), w[:, 1, 0] - w[:, 0, 0]],
                      -1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    h_pos = (pts + rng.uniform(0.32, 0.5, (H, 1)) * normal).astype(np.float32)
    h_vel = rng.uniform(-1, 1, (H, 2)).astype(np.float32)
    return state._replace(h_pos=jnp.asarray(h_pos), h_vel=jnp.asarray(h_vel),
                          r_pos=jnp.asarray(h_pos[0] + 0.4))


@pytest.mark.parametrize("robot_visible", [True, False])
@pytest.mark.parametrize("scenario", ["hallway_bottleneck", "circle_crossing"])
def test_sfm_human_actions(scenario, robot_visible):
    """SFM at a reset (one slot padded) and with the humans pressed against
    the walls and the robot; in the hallway bottleneck walls 2 and up push
    with the bottleneck gains."""
    cfg_ref = _sfm_cfg(scenario, robot_visible)
    cfg = port_cfg(cfg_ref)
    state = CS_ref.reset_host(cfg_ref, 1)
    assert not bool(state.h_mask.all())
    states = [state]
    if bool(np.asarray(state.wall_mask).any()):
        states.append(_near_walls(state))
    for s in states:
        want = HP_ref.human_actions(s, cfg_ref)
        got = HP.human_actions(to_torch(s), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    if scenario == "hallway_bottleneck":
        plain = dataclasses.replace(cfg, scenario="hallway_static")
        moved = HP.human_actions(to_torch(states[-1]), plain)
        assert (moved - got).abs().max() > 1e-3


def test_linear_human_actions():
    cfg_ref = T_ref.EnvConfig(scenario="circle_crossing",
                              human_policy="linear", human_num=4,
                              max_humans=5)
    state = CS_ref.reset_host(cfg_ref, 2)
    want = HP_ref.human_actions(state, cfg_ref)
    got = HP.human_actions(to_torch(state), port_cfg(cfg_ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_sfm_and_linear_on_leading_axes():
    """A stack of states gives each state's own actions."""
    for policy, scenario in (("sfm", "hallway_bottleneck"),
                             ("linear", "circle_crossing")):
        cfg_ref = T_ref.EnvConfig(scenario=scenario, human_policy=policy,
                                  human_num=3, max_humans=4)
        cfg = port_cfg(cfg_ref)
        batch = CS.reset_batch(cfg, [0, 1, 2], device="cpu")
        got = HP.human_actions(batch, cfg)
        for i in range(3):
            want = HP_ref.human_actions(CS_ref.reset_host(cfg_ref, i), cfg_ref)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=0, atol=TOL)


@pytest.mark.parametrize("policy,scenario", [("sfm", "hallway_bottleneck"),
                                             ("linear", "circle_crossing")])
def test_rollout_with_sfm_and_linear_humans(policy, scenario):
    """A 10-step rollout_episode_stateful with each policy's humans."""
    cfg_ref = T_ref.EnvConfig(scenario=scenario, human_policy=policy,
                              human_num=4, max_humans=4,
                              robot_kinematics="unicycle")
    s_ref = CS_ref.reset_host(cfg_ref, 3)
    f_ref, st_ref = RO_ref.rollout_episode_stateful(
        s_ref, jnp.int32(0), _ref_step_fn, cfg_ref, 10)
    f, st = RO.rollout_episode_stateful(to_torch(s_ref), 0, _port_step_fn,
                                        port_cfg(cfg_ref), 10)
    assert int(st_ref.steps) == 10
    assert_tree_close(st, st_ref)
    assert_tree_close(f, f_ref)


def _actions(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.4, 1.0, n),
                     rng.uniform(-0.35, 0.35, n)], -1).astype(np.float32)


@pytest.mark.parametrize("human_num,case", CASES)
def test_step_masked_sequence(human_num, case):
    """Each step from the reference's state is held to 1e-5. The port's own
    20-step trajectory is held to 1e-4: ORCA's contact resolution in the
    jammed bottleneck amplifies ulp-level differences step by step (about
    1e-5 after 20 steps on these cases)."""
    cfg_ref = T_ref.EnvConfig(human_num=human_num)
    cfg = port_cfg(cfg_ref)
    s_ref = CS_ref.reset_host(cfg_ref, case)
    free = to_torch(s_ref)
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    for a in _actions(20, case):
        nxt_ref, r_ref, i_ref = step_ref(s_ref, a, cfg_ref)
        nxt, r, i = CS.step_masked(to_torch(s_ref), torch.as_tensor(a), cfg)
        assert_tree_close(nxt, nxt_ref)
        assert_tree_close(i, i_ref)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=TOL)
        free, _, _ = CS.step_masked(free, torch.as_tensor(a), cfg)
        s_ref = nxt_ref
    assert_tree_close(free, s_ref, tol=1e-4)


ACTIONS = _actions(24, 7)


def _ref_step_fn(state, carry):
    return jnp.asarray(ACTIONS)[carry], carry + 1


def _port_step_fn(state, carry):
    return torch.as_tensor(ACTIONS[carry]), carry + 1


def test_rollout_episode_stateful():
    # start late in the episode so it times out and the masked tail runs
    cfg_ref = T_ref.EnvConfig(human_num=3)
    s_ref = CS_ref.reset_host(cfg_ref, 3)._replace(t=jnp.float32(11.0))
    f_ref, st_ref = RO_ref.rollout_episode_stateful(
        s_ref, jnp.int32(0), _ref_step_fn, cfg_ref, 24)
    f, st = RO.rollout_episode_stateful(to_torch(s_ref), 0, _port_step_fn,
                                        port_cfg(cfg_ref), 24)
    assert bool(st_ref.timeout) and int(st_ref.steps) < 24
    assert_tree_close(st, st_ref)
    assert_tree_close(f, f_ref)



# the definitive protocol's environment: 3 humans in 3 slots, all moving
# from the start, 30 s
PROTOCOL = T_ref.EnvConfig(scenario="hallway_bottleneck",
                           human_policy="orca_plus", human_num=3,
                           max_humans=3, starts_moving=0, time_limit=30,
                           robot_kinematics="unicycle")


@pytest.mark.parametrize("case", [0, 3])
def test_protocol_reset_and_steps(case):
    """Reset and 20 masked steps at the protocol, each from the reference's
    state, held as test_step_masked_sequence holds the default config."""
    cfg = port_cfg(PROTOCOL)
    s_ref = CS_ref.reset_host(PROTOCOL, case)
    assert_tree_close(CS.reset_host(cfg, case, device="cpu"), s_ref)
    assert tuple(s_ref.h_pos.shape) == (3, 2) and bool(s_ref.h_mask.all())
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    for a in _actions(20, 10 + case):
        nxt_ref, r_ref, i_ref = step_ref(s_ref, a, PROTOCOL)
        nxt, r, i = CS.step_masked(to_torch(s_ref), torch.as_tensor(a), cfg)
        assert_tree_close(nxt, nxt_ref)
        assert_tree_close(i, i_ref)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=TOL)
        s_ref = nxt_ref


class _LatchCarry(NamedTuple):
    """A policy carry with a door-yield latch, as campc.CAMPCCarry has one,
    nested one level down as in the fused controller's carry."""
    step: object
    door_latch: object


class _Outer(NamedTuple):
    mpc: _LatchCarry


LATCHED = {2, 3, 4, 9, 10, 15}          # steps after which the latch is set
STILL = {3, 4, 10, 11}                  # steps with a zero action (frozen)


def _latch_actions(k):
    a = ACTIONS[k] if k not in STILL else np.zeros(2, np.float32)
    return a, k in LATCHED


def _ref_latch_fn(state, carry):
    k = carry.mpc.step
    acts = jnp.asarray(np.stack([_latch_actions(i)[0] for i in range(24)]))
    latched = jnp.asarray([_latch_actions(i)[1] for i in range(24)])
    return acts[k], _Outer(_LatchCarry(k + 1, latched[k]))


def _port_latch_fn(state, carry):
    k = carry.mpc.step
    a, latched = _latch_actions(k)
    return torch.as_tensor(a), _Outer(_LatchCarry(k + 1, torch.tensor(latched)))


def test_rollout_counts_door_latch():
    """The yield counts read the policy's door-yield latch from its carry,
    on a run where the latch fires, some of it while the robot stands."""
    s_ref = CS_ref.reset_host(PROTOCOL, 0)
    carry_ref = _Outer(_LatchCarry(jnp.int32(0), jnp.array(False)))
    f_ref, st_ref = RO_ref.rollout_episode_stateful(
        s_ref, carry_ref, _ref_latch_fn, PROTOCOL, 20)
    carry = _Outer(_LatchCarry(0, torch.tensor(False)))
    f, st = RO.rollout_episode_stateful(to_torch(s_ref), carry,
                                        _port_latch_fn, port_cfg(PROTOCOL), 20)
    assert int(st_ref.yield_steps) > 0 and int(st_ref.frozen_yield_steps) > 0
    assert_tree_close(st, st_ref)
    assert_tree_close(f, f_ref)

"""Parity of the port's DWA robot policy (sicnav_tpu_torch.policies.dwa)
with the JAX reference on hallway-bottleneck states.

Tolerance 1e-5 absolute on the action: the window grid, the rollouts and
the scores are the same float32 operations on both sides, and the argmax
picks the same candidate. The motion model is also compared on its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.policies import dwa as D_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import types as T
from sicnav_tpu_torch.policies import dwa as D

torch.set_num_threads(2)
TOL = 1e-5


def _port_cfg(cfg_ref):
    fields = dataclasses.asdict(cfg_ref)
    fields["rewards"] = T.RewardConfig(**fields["rewards"])
    return T.EnvConfig(**fields)


def _to_torch(tree):
    return CS.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


def test_dwa_config_defaults_match():
    assert dataclasses.asdict(D.DWAConfig()) == dataclasses.asdict(D_ref.DWAConfig())


def test_motion_step():
    rng = np.random.default_rng(0)
    state = rng.normal(size=(128, 3)).astype(np.float32)
    v = rng.uniform(-1, 1, 128).astype(np.float32)
    w = rng.uniform(-0.7, 0.7, 128).astype(np.float32)
    w[:16] = rng.uniform(-0.009, 0.009, 16)                 # straight branch
    want = jax.vmap(D_ref._motion_step, in_axes=(0, 0, 0, None))(
        state, v, w, 0.25)
    got = D._motion_step(*map(torch.as_tensor, (state, v, w)), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("case", [0, 4])
def test_dwa_policy(case):
    """DWA along a reference episode: the state at every 3rd of 15 steps,
    with a moving robot, humans and walls in range."""
    cfg_ref = T_ref.EnvConfig(human_num=5)
    cfg = _port_cfg(cfg_ref)
    policy_ref = jax.jit(D_ref.dwa_policy, static_argnames="env_cfg")
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s_ref = CS_ref.reset_host(cfg_ref, case)
    for k in range(15):
        a_ref = policy_ref(s_ref, cfg_ref)
        if k % 3 == 0:
            a = D.dwa_policy(_to_torch(s_ref), cfg)
            np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=TOL)
        s_ref, _, _ = step_ref(s_ref, a_ref, cfg_ref)
    start = np.array([0.0, -cfg_ref.circle_radius])
    assert np.linalg.norm(np.asarray(s_ref.r_pos) - start) > 0.3  # robot moved

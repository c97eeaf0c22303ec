"""Parity of the port's device-side resets and ORCA robot
(``scenarios.generate_device``, ``crowd_sim.reset_device``,
``policies/orca_robot``) with the JAX reference.

- ``generate_device`` handed the uniform draws JAX made from its keys
  places every human where the reference does, to 1e-6 (the same float32
  arithmetic; XLA and PyTorch may round cos/sin by an ulp). Rejection
  decisions and masks must be equal.
- The port's own draws (a ``torch.Generator``) against JAX's over 512
  resets: the two-sample KS test of ``tests/test_env.py`` at alpha = 1e-3
  on each start and goal coordinate.
- ``orca_robot_action`` along a 20-step holonomic rollout of two episodes
  at once: actions and states to 1e-5, as ``tests/test_torch_env.py``
  holds the human steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import scenarios as SC_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.env import walls as W_ref
from sicnav_tpu.policies import orca_robot as OR_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import scenarios as SC
from sicnav_tpu_torch.policies import orca_robot as OR
from tests.test_torch_env import assert_tree_close, port_cfg, to_torch

torch.set_num_threads(2)
SCENARIOS = ["circle_crossing", "square_crossing", "hallway_bottleneck"]


def _cfg(scenario, human_num=5, max_humans=5):
    return T_ref.EnvConfig(
        scenario=scenario,
        human_policy="orca_plus" if scenario.startswith("hallway") else "orca",
        human_num=human_num, max_humans=max_humans, starts_moving=0,
        robot_kinematics="holonomic")


def jax_draws(key, cfg):
    """The unit uniforms the reference's generate_device draws from ``key``,
    per human, laid out as ``scenarios.device_draws``."""
    per_human = []
    for k in jax.random.split(key, cfg.max_humans):
        if cfg.scenario == "circle_crossing":
            k_vp, k_draw = jax.random.split(k)
            d = (jax.random.uniform(k_vp, ()),
                 jax.random.uniform(k_draw, (SC_ref._TRIES, 3)))
        elif cfg.scenario == "square_crossing":
            k_vp, k_sign, k_p, k_g = jax.random.split(k, 4)
            d = (jax.random.uniform(k_vp, ()), jax.random.uniform(k_sign),
                 jax.random.uniform(k_p, (SC_ref._TRIES, 2)),
                 jax.random.uniform(k_g, (SC_ref._TRIES, 2)))
        else:
            ks = jax.random.split(k, 3)
            d = (jax.random.uniform(ks[0], ()),
                 jax.random.uniform(ks[1], (SC_ref._TRIES, 6)),
                 jax.random.uniform(ks[2], (SC_ref._TRIES, 2)))
        per_human.append(d)
    return tuple(np.stack([np.asarray(h[j]) for h in per_human])
                 for j in range(len(per_human[0])))


def batch_draws(keys, cfg):
    """``jax_draws`` of every key, stacked on a leading episode axis."""
    each = [jax_draws(k, cfg) for k in keys]
    return tuple(torch.as_tensor(np.stack([e[j] for e in each]))
                 for j in range(len(each[0])))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("human_num", [3, 5])
def test_generate_device_with_jax_draws(scenario, human_num):
    cfg_ref = _cfg(scenario, human_num)
    cfg = port_cfg(cfg_ref)
    keys = jax.random.split(jax.random.PRNGKey(human_num), 6)
    walls, wmask, _ = W_ref.build_walls(cfg_ref)
    want = jax.vmap(lambda k: SC_ref.generate_device(
        k, cfg_ref, jnp.asarray(walls), jnp.asarray(wmask)))(keys)
    got = SC.generate_device(cfg, len(keys), torch.as_tensor(walls),
                             torch.as_tensor(wmask),
                             draws=batch_draws(keys, cfg_ref))
    for name, g, w in zip(("h_pos", "h_goal", "h_theta", "h_radius",
                           "h_v_pref", "h_mask"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_reset_device_with_jax_draws(scenario):
    cfg_ref = _cfg(scenario)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    want = jax.vmap(lambda k: CS_ref.reset_device(k, cfg_ref))(keys)
    got = CS.reset_device(port_cfg(cfg_ref), len(keys), device="cpu",
                          draws=batch_draws(keys, cfg_ref))
    assert_tree_close(got, want, 1e-6)


def _ks(a, b):
    xs = np.sort(np.concatenate([a, b]))
    ca = np.searchsorted(np.sort(a), xs, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), xs, side="right") / len(b)
    return np.max(np.abs(ca - cb))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_own_draws_match_jax_distribution(scenario):
    cfg_ref = _cfg(scenario)
    cfg = port_cfg(cfg_ref)
    n = 512
    walls, wmask, _ = W_ref.build_walls(cfg_ref)
    gen = jax.jit(jax.vmap(lambda k: SC_ref.generate_device(
        k, cfg_ref, jnp.asarray(walls), jnp.asarray(wmask))))
    r_pos, r_goal, _, _, r_vp, r_mask = gen(
        jax.random.split(jax.random.PRNGKey(0), n))
    g = torch.Generator().manual_seed(0)
    p_pos, p_goal, _, _, p_vp, p_mask = SC.generate_device(
        cfg, n, torch.as_tensor(walls), torch.as_tensor(wmask), generator=g)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(r_mask))
    m = np.asarray(r_mask)
    ref = [np.asarray(x)[m] for x in (r_pos, r_goal)]
    port = [x.numpy()[m] for x in (p_pos, p_goal)]
    k = m.sum()
    crit = 1.95 * np.sqrt(2.0 / k)     # two-sample KS at alpha = 1e-3
    for j, (a, b) in enumerate(zip(port, ref)):
        for c in range(2):
            assert _ks(a[:, c], b[:, c]) < crit, (scenario, j, c)
    assert _ks(p_vp.numpy()[m], np.asarray(r_vp)[m]) < crit


@pytest.mark.parametrize("scenario", ["circle_crossing",
                                      "hallway_bottleneck"])
def test_orca_robot_rollout(scenario):
    """Two episodes stepped together with the ORCA robot, 20 steps."""
    cfg_ref = _cfg(scenario)
    cfg = port_cfg(cfg_ref)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    s_ref = jax.vmap(lambda k: CS_ref.reset_device(k, cfg_ref))(keys)
    s = to_torch(s_ref)
    act_ref = jax.jit(jax.vmap(lambda x: OR_ref.orca_robot_action(x, cfg_ref)))
    step_ref = jax.jit(jax.vmap(lambda x, a: CS_ref.step_masked(x, a,
                                                                cfg_ref)))
    for k in range(20):
        a_ref = act_ref(s_ref)
        a = OR.orca_robot_action(s, cfg)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=0,
                                   atol=1e-5, err_msg=f"step {k}")
        s_ref, _, _ = step_ref(s_ref, a_ref)
        s, _, _ = CS.step_masked(s, a, cfg)
        assert_tree_close(s, s_ref)
    # the robots left their start at (0, -circle_radius)
    assert np.abs(np.asarray(s_ref.r_pos)[:, 1] + cfg.circle_radius).min() > 0.5


def test_one_episode_action():
    """Without episode axes the action is (2,), as the reference's."""
    cfg_ref = _cfg("hallway_bottleneck", 3, 3)
    s_ref = CS_ref.reset_host(cfg_ref, 1)
    a = OR.orca_robot_action(to_torch(s_ref), port_cfg(cfg_ref))
    np.testing.assert_allclose(a.numpy(), np.asarray(
        OR_ref.orca_robot_action(s_ref, cfg_ref)), rtol=0, atol=1e-5)

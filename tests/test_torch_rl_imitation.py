"""Parity of the port's imitation-learning bootstrap
(sicnav_tpu_torch.rl.imitation) with the JAX reference
(sicnav_tpu.rl.imitation).

- ``discounted_reward_to_go`` on random rewards with dead tails: 1e-6.
- ``collect_demonstrations`` over 8 circle-crossing episodes from the
  reference's reset draws, ORCA driving the holonomic robot for the full
  62 steps: the same number of kept states, their values 1e-5, the kept
  robot and human states 1e-4 (62 steps of ORCA contacts can carry
  ulp-level differences to ~1e-5, tests/test_torch_env.py).
- Two ``fit_value_net`` epochs of SARL and RGL from the same parameters
  with the reference's permutations: each epoch's loss and the parameters
  after it 1e-5, the clip binding on the first step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import types as T_ref
from sicnav_tpu.rl import imitation as IL_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.rl import imitation as IL

from tests.test_torch_env import port_cfg
from tests.test_torch_rl_networks import NETS, inputs, port_net, ref_params
from tests.test_torch_scenarios_device import batch_draws

torch.set_num_threads(2)
ENV = T_ref.EnvConfig(scenario="circle_crossing", human_policy="orca",
                      human_num=3, max_humans=3, starts_moving=0,
                      robot_kinematics="unicycle")


def test_discounted_reward_to_go():
    rng = np.random.default_rng(0)
    rewards = rng.normal(0, 0.3, (4, 30)).astype(np.float32)
    live = np.ones((4, 30), bool)
    for i, end in enumerate((30, 17, 5, 1)):
        live[i, end:] = False
    g = np.float32(0.9 ** 0.25)
    got = IL.discounted_reward_to_go(torch.as_tensor(rewards),
                                     torch.as_tensor(live), 0.9 ** 0.25)
    for i in range(4):
        want = IL_ref.discounted_reward_to_go(jnp.asarray(rewards[i]),
                                              jnp.asarray(live[i]), g)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # the oracle: the sum written out
    want0 = [sum(float(g) ** (t - i) * float(rewards[1, t])
                 for t in range(i, 17)) for i in range(17)]
    np.testing.assert_allclose(got[1, :17].numpy(), want0, rtol=0, atol=1e-6)
    assert not got[1, 17:].any()


def test_collect_demonstrations_with_the_reference_draws():
    il = IL_ref.ILConfig()
    seed, n = 3, 8
    want = IL_ref.collect_demonstrations(ENV, il, seed=seed, n_episodes=n)
    cfg_h = dataclasses.replace(ENV, robot_kinematics="holonomic")
    draws = batch_draws(jax.random.split(jax.random.PRNGKey(seed), n), cfg_h)
    got = IL.collect_demonstrations(port_cfg(ENV), IL.ILConfig(),
                                    n_episodes=n, device="cpu", draws=draws)
    assert got[0].shape[0] == want[0].shape[0] > 8 * 5
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 0, 1e-5)):
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
    # the last kept state of a successful episode carries the success reward
    assert 0.9 < float(got[3].max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_two_fit_epochs_match_the_reference(name):
    il_ref = IL_ref.ILConfig(il_epochs=2, batch_size=40)
    N_data = 130                                  # 3 batches, 10 left over
    robot, humans, mask = inputs(6, B=N_data, H=3)
    mask[::4, 2] = False                          # some padded slots
    values = np.random.default_rng(7).uniform(-0.5, 1.0, N_data).astype(
        np.float32)
    params = ref_params(name, seed=9, H=3)
    data = (robot, humans, mask, values)
    p_ref, losses_ref = IL_ref.fit_value_net(NETS[name][0](), data, il_ref,
                                             seed=4, init_params=params)
    # the reference's permutations: one key split per epoch
    key, perms = jax.random.PRNGKey(4), []
    for _ in range(il_ref.il_epochs):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, N_data)))
    net = port_net(name, params)
    norms = []
    clip = MID.clip_by_global_norm_

    def spy(ps, m):
        norms.append(float(clip(ps, m)))

    IL.clip_by_global_norm_ = spy
    try:
        _, losses = IL.fit_value_net(
            net, tuple(map(torch.as_tensor, data)),
            IL.ILConfig(**dataclasses.asdict(il_ref)), perms=perms)
    finally:
        IL.clip_by_global_norm_ = clip
    assert norms[0] > 1.0 and len(norms) == 6
    np.testing.assert_allclose(losses, losses_ref, rtol=0, atol=1e-5)
    got = convert.rl_flax_params(net.state_dict())
    for g, w in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.tree.map(np.asarray, p_ref))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)

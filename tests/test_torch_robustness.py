"""Parity of the port's observation-noise injection
(sicnav_tpu_torch.utils.robustness) with the JAX reference's
(sicnav_tpu.utils.robustness).

Inputs: hallway-bottleneck states of host case 0 at the definitive
protocol (3 humans), after 0 and 5 steps. JAX's PRNG values cannot be
made in torch, so the reference's draws (``fold_in(PRNGKey(seed),
step_idx)``, split in two, one standard normal each) are rebuilt with
``jax.random`` exactly as the reference splits its key and handed to the
port. Tolerance: 1e-6 of max(1, |value|) (one float32 multiply-add).

The port's own draws keep the reference's structure: a function of
(seed, step_idx) only, the same for every episode of a batch at one step,
different across steps and seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.utils import robustness as RB_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.utils import robustness as RB

from tests.test_torch_mpc_ocp import ENV, close
from tests.test_torch_env import to_torch

TOL = 1e-6
CFG = dict(pos_std=0.07, vel_std=0.03, seed=11)


def _states(steps=(0, 5)):
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(ENV, 0)
    out = []
    for k in range(max(steps) + 1):
        if k in steps:
            out.append(s)
        s, _, _ = step(s, jnp.array([0.5, 0.03], jnp.float32), ENV)
    return out


def reference_draws(state, seed):
    """The two standard normals the reference's noisy wrappers draw."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), state.step_idx)
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.normal(k1, state.h_pos.shape)),
            np.array(jax.random.normal(k2, state.h_vel.shape)))


def test_perturb_observation_matches_reference():
    cfg_ref, cfg = RB_ref.NoiseConfig(**CFG), RB.NoiseConfig(**CFG)
    seen = jax.jit(RB_ref.noisy_policy(lambda s: (s.h_pos, s.h_vel),
                                       cfg_ref))
    for s in _states():
        d_pos, d_vel = reference_draws(s, cfg.seed)
        st = to_torch(s)
        got = RB.perturb_observation(st, cfg, draws=(torch.as_tensor(d_pos),
                                                     torch.as_tensor(d_vel)))
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), s.step_idx)
        want = RB_ref.perturb_observation(s, key, cfg_ref)
        close(got.h_pos, want.h_pos, TOL, "h_pos")
        close(got.h_vel, want.h_vel, TOL, "h_vel")
        pos_w, vel_w = seen(s)
        close(got.h_pos, pos_w, TOL, "h_pos through noisy_policy")
        close(got.h_vel, vel_w, TOL, "h_vel through noisy_policy")
        # only the humans' observation moves
        for name in ("r_pos", "r_vel", "h_goal", "h_radius", "step_idx"):
            assert torch.equal(getattr(got, name), getattr(st, name)), name


def test_batched_equals_per_episode():
    """A batch of states with draws per episode against each alone."""
    cfg = RB.NoiseConfig(**CFG)
    states = _states()
    batch = CS.stack([to_torch(s) for s in states])
    draws = [reference_draws(s, cfg.seed) for s in states]
    got = RB.perturb_observation(batch, cfg, draws=tuple(
        torch.as_tensor(np.stack(d)) for d in zip(*draws)))
    for i, (s, d) in enumerate(zip(states, draws)):
        one = RB.perturb_observation(to_torch(s), cfg,
                                     draws=tuple(map(torch.as_tensor, d)))
        assert torch.equal(got.h_pos[i], one.h_pos)
        assert torch.equal(got.h_vel[i], one.h_vel)
    # the port's own draws, batched and alone
    got = RB.perturb_observation(batch, cfg)
    for i, s in enumerate(states):
        one = RB.perturb_observation(to_torch(s), cfg)
        assert torch.equal(got.h_pos[i], one.h_pos)
        assert torch.equal(got.h_vel[i], one.h_vel)


def test_draws_depend_on_seed_and_step_only():
    """Every episode of a batch at one step sees one draw, as under the
    reference's vmapped harness; steps and seeds draw anew."""
    cfg = RB.NoiseConfig(**CFG)
    s0, s5 = (to_torch(s) for s in _states())
    same_step = CS.stack([s0, s0._replace(h_pos=s0.h_pos + 1.0), s0])
    d_pos, d_vel = RB.step_draws(same_step, cfg)
    assert d_pos.shape == same_step.h_pos.shape
    for i in (1, 2):
        assert torch.equal(d_pos[i], d_pos[0])
        assert torch.equal(d_vel[i], d_vel[0])
    assert not torch.equal(d_pos[0], d_vel[0])
    mixed = CS.stack([s0, s5, s0])
    m_pos, _ = RB.step_draws(mixed, cfg)
    assert torch.equal(m_pos[0], m_pos[2]) and torch.equal(m_pos[0], d_pos[0])
    assert not torch.equal(m_pos[1], m_pos[0])
    assert torch.equal(m_pos[1], RB.step_draws(s5, cfg)[0])
    other = RB.step_draws(s0, RB.NoiseConfig(**dict(CFG, seed=12)))[0]
    assert not torch.equal(other, d_pos[0])
    # standard normals: 30 draws of 6 values are not far off N(0, 1)
    many = torch.stack([RB.step_draws(s0._replace(step_idx=torch.tensor(
        k, dtype=torch.int32)), cfg)[0] for k in range(30)])
    assert abs(many.mean().item()) < 0.25 and 0.75 < many.std().item() < 1.25


def test_noisy_policy_stateful_threads_the_carry():
    cfg = RB.NoiseConfig(**CFG)
    s0, s5 = (to_torch(s) for s in _states())
    seen = []

    def step_fn(state, carry):
        seen.append(state)
        return state.h_pos.sum(-1), carry + 1, "aux"

    wrapped = RB.noisy_policy_stateful(step_fn, cfg)
    carry = torch.tensor(0)
    for s in (s0, s5, s5):
        out = wrapped(s, carry)
        assert out[2] == "aux" and int(out[1]) == int(carry) + 1
        carry = out[1]
        want = RB.perturb_observation(s, cfg)
        assert torch.equal(seen[-1].h_pos, want.h_pos)
        assert torch.equal(seen[-1].h_vel, want.h_vel)
        assert torch.equal(out[0], want.h_pos.sum(-1))
    assert int(carry) == 3
    assert torch.equal(seen[1].h_pos, seen[2].h_pos)   # same step, same draw
    stateless = RB.noisy_policy(lambda s: s.h_vel, cfg)
    assert torch.equal(stateless(s5), RB.perturb_observation(s5, cfg).h_vel)

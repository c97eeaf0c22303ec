"""Parity of the port's observation-path Kalman filter
(sicnav_tpu_torch.utils.state_filter) with the JAX reference's
(sicnav_tpu.utils.state_filter).

Inputs: constant-velocity tracks of 4 humans over 60 steps with 5 cm
position and velocity noise, built as tests/test_state_filter.py builds
them but drawn from a seed with numpy, and hallway-bottleneck states of
host case 0 for the wrappers. Tolerance: 1e-6 of max(1, |value|) for
every filtered position, velocity and covariance (the same float32
operations; a 2 x 2 solve per step). The first call seeds the state with
the observation and P with R exactly, on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sicnav_tpu.utils import robustness as RB_ref
from sicnav_tpu.utils import state_filter as SF_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.utils import robustness as RB
from sicnav_tpu_torch.utils import state_filter as SF

from tests.test_torch_env import to_torch
from tests.test_torch_mpc_ocp import close
from tests.test_torch_robustness import CFG, _states, reference_draws

TOL = 1e-6
CONFIGS = [dict(dt=0.25, pos_std=0.05, vel_std=0.05),
           dict(dt=0.25, pos_std=0.05, vel_std=0.05, accel_std=0.5)]


def _track(seed, H=4, T=60, dt=0.25, std=0.05):
    """Noisy observations of a constant-velocity track: (T, H, 2) each."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-3.0, 3.0, (H, 2))
    v = rng.uniform(-1.0, 1.0, (H, 2))
    pos = p0[None] + v[None] * (np.arange(T)[:, None, None] * dt)
    pos_obs = pos + std * rng.normal(size=pos.shape)
    vel_obs = v[None] + std * rng.normal(size=pos.shape)
    return pos_obs.astype(np.float32), vel_obs.astype(np.float32)


def test_kf_step_matches_reference():
    for i, kw in enumerate(CONFIGS):
        cfg_ref, cfg = SF_ref.KFConfig(**kw), SF.KFConfig(**kw)
        step_ref = jax.jit(lambda p, v, kf: SF_ref.kf_step(p, v, kf, cfg_ref))
        pos_obs, vel_obs = _track(i)
        kf_ref, kf = SF_ref.init_filter(4), SF.init_filter(4, device="cpu")
        for t in range(pos_obs.shape[0]):
            p_w, v_w, kf_ref = step_ref(pos_obs[t], vel_obs[t], kf_ref)
            p, v, kf = SF.kf_step(torch.as_tensor(pos_obs[t]),
                                  torch.as_tensor(vel_obs[t]), kf, cfg)
            close(p, p_w, TOL, f"pos {t}")
            close(v, v_w, TOL, f"vel {t}")
            close(kf.P, kf_ref.P, TOL, f"P {t}")
            close(kf.x, kf_ref.x, TOL, f"x {t}")
            assert bool(kf.initialized)
        # the filter smooths: late positions closer to the track's line
        assert kf.P[0, 0] < cfg.pos_std ** 2


def test_first_call_seeds_the_state():
    cfg = SF.KFConfig()
    pos_obs, vel_obs = (torch.as_tensor(x[0]) for x in _track(3))
    kf = SF.init_filter(4, device="cpu")
    assert not bool(kf.initialized)
    p, v, kf1 = SF.kf_step(pos_obs, vel_obs, kf, cfg)
    assert torch.equal(p, pos_obs) and torch.equal(v, vel_obs)
    _, _, R = SF._matrices(cfg)
    assert torch.equal(kf1.P, R)
    assert torch.equal(kf1.x, torch.cat([pos_obs, vel_obs], -1))
    _, _, R_ref = SF_ref._matrices(SF_ref.KFConfig())
    np.testing.assert_array_equal(R.numpy(), np.asarray(R_ref))


def test_batched_equals_single_runs():
    """B = 3 episodes, the third one's filter seeded 7 steps late, so the
    episodes hold different P: each equals its own run."""
    cfg = SF.KFConfig(**CONFIGS[1])
    tracks = [_track(10 + b) for b in range(3)]
    pos = torch.as_tensor(np.stack([t[0] for t in tracks], 1))   # (T, B, H, 2)
    vel = torch.as_tensor(np.stack([t[1] for t in tracks], 1))
    kf_b = SF.init_filter(4, batch=3, device="cpu")
    assert kf_b.P.shape == (3, 2, 2) and kf_b.initialized.shape == (3,)
    singles = [SF.init_filter(4, device="cpu") for _ in range(3)]
    differed = 0
    for t in range(40):
        if t == 7:
            kf_b = kf_b._replace(initialized=torch.tensor([True, True, False]))
            singles[2] = SF.init_filter(4, device="cpu")
        p_b, v_b, kf_b = SF.kf_step(pos[t], vel[t], kf_b, cfg)
        for b in range(3):
            p, v, singles[b] = SF.kf_step(pos[t, b], vel[t, b], singles[b],
                                          cfg)
            close(p_b[b], p, TOL, f"pos {t} {b}")
            close(v_b[b], v, TOL, f"vel {t} {b}")
            close(kf_b.P[b], singles[b].P, TOL, f"P {t} {b}")
        differed += int(not torch.allclose(kf_b.P[0], kf_b.P[2]))
    assert differed >= 5, differed


def test_wrappers_match_reference():
    """filtered_policy_stateful's carry over three steps, inside the noise
    wrapper (noise, then the filter, then the policy), against the
    reference's composition on the same noise; the port's own composed
    wrapper equals the same steps done by hand."""
    kf_cfg_ref = SF_ref.KFConfig(pos_std=0.07, vel_std=0.07)
    kf_cfg = SF.KFConfig(pos_std=0.07, vel_std=0.07)
    noise_ref, noise = RB_ref.NoiseConfig(**CFG), RB.NoiseConfig(**CFG)

    def inner_ref(state, carry):
        return state.h_pos[:, 0] + state.h_vel[:, 1], carry + 1

    def inner(state, carry):
        return state.h_pos[:, 0] + state.h_vel[:, 1], carry + 1

    pol_ref = jax.jit(SF_ref.filtered_policy_stateful(inner_ref, kf_cfg_ref))
    pol = SF.filtered_policy_stateful(inner, kf_cfg)
    carry_ref = (SF_ref.init_filter(3), jnp.int32(0))
    carry = (SF.init_filter(3, device="cpu"), torch.tensor(0))
    for s in _states((0, 1, 2)):
        key = jax.random.fold_in(jax.random.PRNGKey(noise.seed), s.step_idx)
        a_w, carry_ref = pol_ref(
            RB_ref.perturb_observation(s, key, noise_ref), carry_ref)
        draws = tuple(map(torch.as_tensor, reference_draws(s, noise.seed)))
        a, carry = pol(RB.perturb_observation(to_torch(s), noise, draws),
                       carry)
        close(a, a_w, TOL, "action")
        close(carry[0].x, carry_ref[0].x, TOL, "filtered state")
        close(carry[0].P, carry_ref[0].P, TOL, "P")
        assert int(carry[1]) == int(carry_ref[1])
    # the composed wrapper: noise outside, the filter inside
    composed = RB.noisy_policy_stateful(pol, noise)
    carry = (SF.init_filter(3, device="cpu"), torch.tensor(0))
    kf = SF.init_filter(3, device="cpu")
    for s in _states((0, 1, 2)):
        st = to_torch(s)
        a, carry = composed(st, carry)
        seen, kf = SF.filter_observation(RB.perturb_observation(st, noise),
                                         kf, kf_cfg)
        assert torch.equal(a, inner(seen, 0)[0])
        assert torch.equal(carry[0].x, kf.x)
    # a batch of carries, as the harness holds them
    batch = CS.stack([to_torch(s) for s in _states((0, 1))])
    a_b, (kf_b, inner_b) = pol(batch, (SF.init_filter(3, batch=2,
                                                      device="cpu"),
                                       torch.zeros(2)))
    assert a_b.shape[0] == 2 and kf_b.x.shape == (2, 3, 4)
    assert bool(kf_b.initialized.all()) and inner_b.tolist() == [1.0, 1.0]


def test_filter_carry_is_one_tree():
    """The filter's carry is a plain (KFState, inner) tuple: crowd_sim's
    tree helpers descend it like a NamedTuple (the reference's pytrees do),
    so a batch of such carries slices, flattens and rebuilds, and the
    rollout finds the inner controller's door latch inside it."""
    from typing import NamedTuple

    from sicnav_tpu_torch.env import rollout

    class Inner(NamedTuple):
        door_latch: torch.Tensor
        n: torch.Tensor

    carry = (SF.init_filter(3, batch=2, device="cpu"),
             Inner(torch.tensor([1, 0]), torch.arange(2.0)))
    one = CS.tree_map(lambda x: x[1], carry)
    assert type(one) is tuple and isinstance(one[0], SF.KFState)
    assert int(one[1].door_latch) == 0 and one[0].P.shape == (2, 2)
    leaves = CS.tree_leaves(carry)
    assert len(leaves) == len(SF.KFState._fields) + 2
    back = CS.tree_unflatten(carry, leaves)
    assert type(back) is tuple and type(back[1]) is Inner
    assert all(a is b for a, b in zip(CS.tree_leaves(back), leaves))
    assert rollout._carry_field(carry, "door_latch") is carry[1].door_latch
    assert rollout._carry_field(carry, "door_stall") is None
    stacked = CS.stack([one, one])
    assert torch.equal(stacked[1].n, torch.tensor([1.0, 1.0]))

"""The port's robocentric transforms and FOV occlusion
(sicnav_tpu_torch/env/occlusion.py) against the reference's
(sicnav_tpu/env/occlusion.py).

- The reference's three occlusion cases (tests/test_env.py).
- Seeded random crowds (up to 8 humans, random masks, radii 0.2-0.5,
  720 and 90 bins): the visibility mask EQUAL to the reference's.
- ``robocentric_state`` and ``robocentric_goal_aligned`` on host resets
  with a random robot heading and random velocities: within 1e-5.
- A batch of episodes in one call equals the per-episode calls (exactly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import occlusion as OC_ref
from sicnav_tpu.env.types import EnvConfig as EnvConfig_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import occlusion as OC
from sicnav_tpu_torch.env.types import DoorParams, SimState

TOL = 1e-5
SCENARIOS = ("hallway_bottleneck", "circle_crossing", "hallway_static")


def _crowd(rng, H):
    pos = rng.uniform(-4.0, 4.0, (H, 2)).astype(np.float32)
    radius = rng.uniform(0.2, 0.5, (H,)).astype(np.float32)
    mask = rng.random(H) < 0.8
    return pos, radius, mask


def test_reference_cases():
    r = np.full((3,), 0.3, np.float32)
    cases = [
        (np.array([[1.0, 0.0], [2.5, 0.0], [0.0, 2.0]], np.float32),
         np.array([True, True, True]), [True, False, True]),
        (np.array([[1.0, 0.0], [2.5, 1.8], [0.0, 2.0]], np.float32),
         np.array([True, True, True]), [True, True, True]),
        (np.array([[1.0, 0.0], [2.5, 0.0], [0.0, 2.0]], np.float32),
         np.array([False, True, True]), [False, True, True]),
    ]
    for pos, mask, want in cases:
        got = OC.occlusion_mask(torch.as_tensor(pos), torch.as_tensor(r),
                                torch.as_tensor(mask))
        ref = OC_ref.occlusion_mask(jnp.asarray(pos), jnp.asarray(r),
                                    jnp.asarray(mask))
        assert got.tolist() == want == np.asarray(ref).tolist()


@pytest.mark.parametrize("n_bins", [720, 90])
def test_random_crowds_equal(n_bins):
    rng = np.random.default_rng(n_bins)
    ref_fn = jax.jit(OC_ref.occlusion_mask, static_argnums=3)
    hidden = 0
    for H in (1, 2, 3, 5, 8):
        for _ in range(12):
            pos, radius, mask = _crowd(rng, H)
            if H > 2 and rng.random() < 0.5:
                # a human straight behind a nearer one
                pos[1] = pos[0] * rng.uniform(1.3, 2.0)
            got = OC.occlusion_mask(torch.as_tensor(pos),
                                    torch.as_tensor(radius),
                                    torch.as_tensor(mask), n_bins)
            ref = np.asarray(ref_fn(pos, radius, mask, n_bins))
            assert got.numpy().tolist() == ref.tolist(), (pos, radius, mask)
            hidden += int((mask & ~ref).sum())
    assert hidden > 0          # the crowds occlude someone


def _to_port(ref_state):
    """A reference SimState as the port's (CPU tensors)."""
    def t(x):
        return torch.as_tensor(np.array(x))
    fields = {k: t(getattr(ref_state, k)) for k in SimState._fields
              if k != "door"}
    door = DoorParams(**{k: t(getattr(ref_state.door, k))
                         for k in DoorParams._fields})
    return SimState(door=door, **fields)


def _perturbed_reset(scenario, case, rng):
    cfg = EnvConfig_ref(scenario=scenario, human_num=3, max_humans=5)
    s = CS_ref.reset_host(cfg, case=case)
    H = s.h_pos.shape[0]
    return s._replace(
        r_theta=jnp.float32(rng.uniform(-np.pi, np.pi)),
        r_vel=jnp.asarray(rng.normal(size=2), jnp.float32),
        h_vel=jnp.asarray(rng.normal(size=(H, 2)), jnp.float32),
        h_theta=jnp.asarray(rng.uniform(-np.pi, np.pi, H), jnp.float32))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_robocentric_transforms(scenario):
    rng = np.random.default_rng(7)
    for case in (0, 3):
        ref = _perturbed_reset(scenario, case, rng)
        port = _to_port(ref)
        got = OC.robocentric_state(port)
        want = OC_ref.robocentric_state(ref)
        for k in SimState._fields:
            if k == "door":
                continue
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=0, atol=TOL, err_msg=k)
        robot, humans = OC.robocentric_goal_aligned(port)
        robot_r, humans_r = OC_ref.robocentric_goal_aligned(ref)
        np.testing.assert_allclose(robot.numpy(), np.asarray(robot_r),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(humans.numpy(), np.asarray(humans_r),
                                   rtol=0, atol=TOL)
        assert OC.observable_humans(port).tolist() == \
            np.asarray(OC_ref.observable_humans(ref)).tolist()


def test_batched_equals_per_episode():
    rng = np.random.default_rng(3)
    states = [_to_port(_perturbed_reset(s, c, rng))
              for s in ("hallway_bottleneck",) for c in range(4)]
    batch = CS.stack(states)
    got = OC.robocentric_state(batch)
    for b, s in enumerate(states):
        one = OC.robocentric_state(s)
        for k in SimState._fields:
            if k != "door":
                assert torch.equal(getattr(got, k)[b], getattr(one, k)), k
    robot, humans = OC.robocentric_goal_aligned(batch)
    vis = OC.observable_humans(batch)
    for b, s in enumerate(states):
        r1, h1 = OC.robocentric_goal_aligned(s)
        assert torch.equal(robot[b], r1) and torch.equal(humans[b], h1)
        assert torch.equal(vis[b], OC.observable_humans(s))
    # random crowds on two leading axes
    pos, radius, mask = zip(*[_crowd(rng, 6) for _ in range(6)])
    pos, radius, mask = (torch.as_tensor(np.stack(x)).reshape(
        2, 3, *np.shape(x[0])) for x in (pos, radius, mask))
    vis = OC.occlusion_mask(pos, radius, mask, 90)
    for i in range(2):
        for j in range(3):
            assert torch.equal(vis[i, j], OC.occlusion_mask(
                pos[i, j], radius[i, j], mask[i, j], 90))

"""Parity of the port's geometry and ORCA (sicnav_tpu_torch.ops) with the
JAX reference (sicnav_tpu.ops) on random scenes.

Both sides get the same numpy inputs; the port runs on the CPU. Tolerance
1e-5 absolute: both sides do the same float32 operations in the same order,
so they differ only where XLA and PyTorch round a transcendental or a
reduction differently (a few ulp of values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.ops import geometry as G_ref
from sicnav_tpu.ops import orca as O_ref
from sicnav_tpu_torch.ops import geometry as G
from sicnav_tpu_torch.ops import orca as O

torch.set_num_threads(2)
TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry(seed):
    rng = np.random.default_rng(seed)
    pts = [rng.normal(size=(64, 2)).astype(np.float32) for _ in range(4)]
    pts[3][:8] = pts[2][:8]                     # degenerate segments
    th = rng.uniform(-10, 10, 64).astype(np.float32)
    q = np.concatenate([pts[0], th[:, None]], -1)
    for name, args in [
            ("det2", pts[:2]), ("dot2", pts[:2]), ("norm2", pts[:1]),
            ("normalize", pts[:1]), ("closest_point_on_segment", pts[:3]),
            ("closest_point_on_line", pts[:3]),
            ("point_to_segment_dist", pts[:3]),
            ("line_intersection", pts), ("seg_seg_dist", pts),
            ("wrap_angle", [th]), ("rot_2d", [th, pts[0]]),
            ("tsf_2d", [q, pts[1]])]:
        want = getattr(G_ref, name)(*[jnp.asarray(a) for a in args])
        got = getattr(G, name)(*[_t(a) for a in args])
        _close(got, want, 1e-5 if name != "line_intersection" else 1e-3)
    for a, b in zip(G.seg_seg_closest(*map(_t, pts)),
                    G_ref.seg_seg_closest(*map(jnp.asarray, pts))):
        _close(a, b)


def test_linspace_matches_jnp():
    # same formula as jnp.linspace; XLA's compiled division and products
    # round interior points differently: within 2 ulp of the end points
    for lo, hi, n in [(-0.3, 0.7, 8), (np.log(0.01), np.log(0.1), 8),
                      (-0.698, 0.26, 64)]:
        got = G.linspace(torch.tensor(lo, dtype=torch.float32), hi, n)
        want = jnp.linspace(jnp.float32(lo), jnp.float32(hi), n)
        want = np.asarray(want)
        ulp = np.spacing(np.float32(max(abs(lo), abs(hi))))
        assert np.all(np.abs(got.numpy() - want) <= 2 * ulp)


def _scene(seed, B=6, N=9, W=4):
    """Agents in a crowded 4 m square with random walls; some overlap."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-2, 2, s).astype(np.float32)
    walls = f(W, 2, 2)
    return dict(
        pos=f(B, 2), vel=0.8 * f(B, 2), rad=np.full(B, 0.32, np.float32),
        pref=0.7 * f(B, 2), vmax=rng.uniform(0.5, 1.5, B).astype(np.float32),
        npos=f(B, N, 2), nvel=0.8 * f(B, N, 2),
        nrad=np.full((B, N), 0.32, np.float32),
        nmask=rng.random((B, N)) < 0.8,
        ep1=np.concatenate([walls[:, 0], walls[:, 1]]),
        ep2=np.concatenate([walls[:, 1], walls[:, 0]]),
        emask=np.ones(2 * W, bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agent_orca_lines(seed):
    s = _scene(seed)
    want = jax.vmap(O_ref.agent_orca_lines,
                    in_axes=(0, 0, 0, None, 0, 0, 0, 0, None, None))(
        s["pos"], s["vel"], s["rad"], None, s["npos"], s["nvel"], s["nrad"],
        s["nmask"], 2.0, 0.25)
    got = O.agent_orca_lines(*[_t(s[k]) for k in (
        "pos", "vel", "rad", "npos", "nvel", "nrad", "nmask")], 2.0, 0.25)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obstacle_orca_lines(seed):
    s = _scene(seed, B=16)
    B, E = s["pos"].shape[0], s["ep1"].shape[0]
    ep1 = np.broadcast_to(s["ep1"], (B, E, 2))
    ep2 = np.broadcast_to(s["ep2"], (B, E, 2))
    # rotate the edge order per agent so the pruning sees different orders
    order = np.stack([np.roll(np.arange(E), b) for b in range(B)])
    ep1 = np.take_along_axis(ep1, order[..., None], 1)
    ep2 = np.take_along_axis(ep2, order[..., None], 1)
    # slots as orca_velocity fills them: an agent sees an edge only from its
    # right side. The line of a masked slot is never read; on the far side
    # of a wall it can sit on an exact tie of the cut line and a foreign
    # leg, which XLA's compiled arithmetic breaks either way.
    d, q = ep2 - ep1, s["pos"][:, None] - ep1
    right_of = d[..., 0] * q[..., 1] - d[..., 1] * q[..., 0] < 0
    emask = right_of & (np.random.default_rng(seed).random((B, E)) < 0.9)
    assert emask.sum() > B
    want = jax.vmap(O_ref.obstacle_orca_lines,
                    in_axes=(0, 0, 0, 0, 0, 0, None))(
        s["pos"], s["vel"], s["rad"], ep1, ep2, emask, 0.5)
    got = O.obstacle_orca_lines(_t(s["pos"]), _t(s["vel"]), _t(s["rad"]),
                                _t(ep1), _t(ep2), _t(emask), 0.5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        _close(a.numpy()[emask], np.asarray(b)[emask])


def _random_lines(seed, B=64, L=8):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (B, L))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    points = rng.uniform(-0.6, 0.6, (B, L, 2)).astype(np.float32)
    valid = rng.random((B, L)) < 0.85
    is_obst = np.zeros((B, L), bool)
    is_obst[:, :3] = rng.random((B, 3)) < 0.5
    radius = rng.uniform(0.5, 1.5, B).astype(np.float32)
    pref = rng.uniform(-1.5, 1.5, (B, 2)).astype(np.float32)
    return points, dirs, valid, is_obst, radius, pref


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_orca_lp_reaches_lp3(seed):
    points, dirs, valid, is_obst, radius, pref = _random_lines(seed)
    _, fail = jax.vmap(lambda p, d, v, r, o: O_ref._lp2(p, d, v, r, o, False))(
        points, dirs, valid, radius, pref)
    n_lp3 = int((np.asarray(fail) >= 0).sum())
    assert 5 <= n_lp3 < len(radius), n_lp3      # both branches exercised
    want = jax.vmap(O_ref.solve_orca_lp)(points, dirs, valid, is_obst, radius,
                                         pref)
    got = O.solve_orca_lp(*map(_t, (points, dirs, valid, is_obst, radius, pref)))
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orca_velocity(seed):
    s = _scene(seed)
    B, E = s["pos"].shape[0], s["ep1"].shape[0]
    params = O_ref.OrcaParams()
    want = jax.vmap(lambda *a: O_ref.orca_velocity(*a, params, max_neighbors=6),
                    in_axes=(0,) * 9 + (None,) * 3)(
        *[s[k] for k in ("pos", "vel", "rad", "pref", "vmax", "npos", "nvel",
                         "nrad", "nmask", "ep1", "ep2", "emask")])
    rows = lambda x: _t(np.broadcast_to(x, (B,) + x.shape))
    got = O.orca_velocity(
        *[_t(s[k]) for k in ("pos", "vel", "rad", "pref", "vmax", "npos",
                             "nvel", "nrad", "nmask")],
        rows(s["ep1"]), rows(s["ep2"]), rows(s["emask"]), O.OrcaParams(),
        max_neighbors=6)
    _close(got, want)


def test_walls_to_edges():
    rng = np.random.default_rng(3)
    walls = rng.normal(size=(4, 2, 2)).astype(np.float32)
    wmask = np.array([True, False, True, True])
    for a, b in zip(O.walls_to_edges(_t(walls), _t(wmask)),
                    O_ref.walls_to_edges(walls, wmask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

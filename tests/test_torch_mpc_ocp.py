"""Parity of the port's MPC model layer (sicnav_tpu_torch.mpc.orca_lines,
ref_traj, ocp) with the JAX reference (sicnav_tpu.mpc).

Inputs: ORCA geometry and references drawn from a seed with numpy; the OCP
at the definitive protocol's configuration (the RA-L 8-state capsule robot,
acados slacks, close-to-preds over 10 samples, 3 humans, 4 walls) and at
the T-RO 4-state circle configuration, with problem data built by the
reference's own ``build_params`` on hallway-bottleneck states of host case
0 (the episode's start and a state near the door), and decision vectors z
drawn from a seed around the scale of a warmstart.

Tolerances, each relative to the largest entry of the reference's value
(or 1, if larger), over the whole array:
- ORCA lines, references, cost, equality and inequality rows, rollout and
  inferred slacks: 1e-5 (the same float32 operations; XLA and PyTorch round
  transcendentals and reductions differently by a few ulp);
- Jacobians of the rows and the cost gradient: 1e-4 (the port takes them in
  reverse mode, the reference in forward mode: the same derivatives summed
  in other orders);
- the Lagrangian Hessian: 1e-3 of its largest entry (its diagonal spans the
  1e4-1e6 slack-penalty curvature).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu.mpc import orca_lines as OL_ref
from sicnav_tpu.mpc import ref_traj as RT_ref
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import orca_lines as OL
from sicnav_tpu_torch.mpc import ref_traj as RT

torch.set_num_threads(2)
jax.config.update("jax_enable_x64", False)

ENV = T_ref.EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                      human_num=3, max_humans=3, starts_moving=0,
                      time_limit=30, robot_kinematics="unicycle")
PROTOCOL = dict(num_hums=3, num_walls=4, dt=0.25, priviledged_info=True,
                close_to_preds=True, num_mid_samples=10, robot_nx=8,
                robot_capsule=True, term_q_coeff=75.0, slack_mode="acados",
                wall_margin=0.10, door_yield=True)
TRO = dict(num_hums=3, num_walls=4, dt=0.25, priviledged_info=True)


def close(got, want, tol, what=""):
    """max |got - want| <= tol * max(1, max |want|)."""
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def t(x):
    return torch.as_tensor(np.array(x))


def to_torch(tree):
    """A reference NamedTuple (possibly nested) -> the same with tensors."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_torch(x) for x in tree])
    return t(tree)


# ----------------------------------------------------------------- lines

def _pairs(rng, n):
    pos_a = rng.uniform(-2, 2, (n, 2))
    # a third of the pairs overlap (the in-collision branch)
    off = rng.normal(0, 1.0, (n, 2))
    off[: n // 3] *= 0.2
    pos_b = pos_a + off
    return [x.astype(np.float32) for x in (
        pos_a, rng.normal(0, 0.6, (n, 2)), pos_b, rng.normal(0, 0.6, (n, 2)),
        rng.uniform(0.25, 0.35, n), rng.uniform(0.25, 0.35, n))]


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_line(seed):
    args = _pairs(np.random.default_rng(seed), 60)
    op_ref, op = OL_ref.OrcaModelParams(), OL.OrcaModelParams()
    want = jax.jit(jax.vmap(lambda *a: OL_ref.pairwise_line(*a, op_ref)))(*args)
    got = OL.pairwise_line(*[t(a) for a in args], op)
    for g, w, name in zip(got, want, ("norm", "scalar")):
        close(g, w, 1e-5, name)


def test_static_line():
    rng = np.random.default_rng(2)
    n = 80
    pos = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 0.6, (n, 2)).astype(np.float32)
    rad = rng.uniform(0.25, 0.35, n).astype(np.float32)
    walls = rng.uniform(-2.5, 2.5, (n, 2, 2)).astype(np.float32)
    # some agents within their radius of a wall or its end point
    walls[:10, 0] = pos[:10] + rng.normal(0, 0.1, (10, 2))
    mask = rng.uniform(size=n) > 0.2
    op_ref, op = OL_ref.OrcaModelParams(), OL.OrcaModelParams()
    want = jax.jit(jax.vmap(lambda *a: OL_ref.static_line(*a, op_ref)))(
        pos, vel, rad, walls, mask)
    got = OL.static_line(t(pos), t(vel), t(rad), t(walls), t(mask), op)
    for g, w, name in zip(got, want, ("norm", "scalar")):
        close(g, w, 1e-5, name)


def test_v_pref_and_lower_level_cost():
    rng = np.random.default_rng(3)
    pos, goal = (rng.uniform(-3, 3, (50, 2)).astype(np.float32)
                 for _ in range(2))
    goal[:5] = pos[:5] + 1e-3
    v_max = rng.uniform(0.5, 1.5, 50).astype(np.float32)
    want = jax.vmap(OL_ref.v_pref_from_state)(pos, goal, v_max)
    got = OL.v_pref_from_state(t(pos), t(goal), t(v_max))
    close(got, want, 1e-5, "v_pref")
    v = rng.normal(0, 1, (50, 2)).astype(np.float32)
    ksi = rng.normal(0, 0.1, 50).astype(np.float32)
    close(OL.lower_level_cost(t(v), t(ksi), got),
          jax.vmap(OL_ref.lower_level_cost)(v, ksi, want), 1e-5, "cost")


@pytest.mark.parametrize("case", range(4))
def test_point_stab_reference(case):
    rng = np.random.default_rng(10 + case)
    pos = rng.uniform(-3, 3, 2).astype(np.float32)
    theta = np.float32(rng.uniform(-np.pi, np.pi))
    # far, near (one cruise step), within the robot radius (rotate first)
    d = [3.0, 0.4, 0.1, 0.0][case]
    goal = (pos + d * np.array([np.cos(1.0), np.sin(1.0)])).astype(np.float32)
    args = (4, 0.25, 0.9, float(60 * np.pi / 180), 0.25)
    want = RT_ref.point_stab_reference(jnp.asarray(pos), jnp.float32(theta),
                                       jnp.asarray(goal), *args)
    got = RT.point_stab_reference(t(pos), torch.tensor(theta), t(goal),
                                  *args[:-1], torch.tensor(0.25))
    close(got[0], want[0], 1e-5, "poses")
    close(got[1], want[1], 1e-5, "actions")


# ------------------------------------------------------------------- OCP

def _states():
    """Host case 0 at its start and after 14 steps toward the door."""
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(ENV, 0)
    out = [s]
    for _ in range(14):
        s, _, _ = step(s, jnp.array([0.6, 0.0], jnp.float32), ENV)
    return out + [s]


def _mid(state, seed, S=10, K=4):
    rng = np.random.default_rng(seed)
    steps = np.arange(K + 2)[None, None, :, None] * 0.25
    base = np.asarray(state.h_pos)[None, :, None, :] + \
        np.asarray(state.h_vel)[None, :, None, :] * steps
    samples = base + rng.normal(0, 0.08, (S, 3, K + 2, 2)) * steps
    logw = rng.normal(0, 1, S)
    return (samples.astype(np.float32),
            (logw - np.log(np.exp(logw).sum())).astype(np.float32))


def _z(cfg, seed):
    """A decision vector at a warmstart's scale."""
    rng = np.random.default_rng(seed)
    K, Ko, H, nl = cfg.K, cfg.K_orca, cfg.num_hums, cfg.n_lam
    u_rob = np.stack([rng.uniform(0.0, 0.8, K), rng.uniform(-0.6, 0.6, K)], -1)
    u_hums = np.concatenate([rng.normal(0, 0.6, (Ko, H, 2)),
                             np.abs(rng.normal(0, 2.0, (Ko, H, 1)))], -1)
    lam = np.abs(rng.normal(0, 0.5, (Ko, H, nl)))
    lam[rng.uniform(size=lam.shape) < 0.5] = 0.0
    slacks = np.abs(rng.normal(0, 0.05, cfg.n_slack))
    slacks[rng.uniform(size=slacks.shape) < 0.4] = 0.0   # exactly 0, a kink
    z = np.concatenate([u_rob.ravel(), u_hums.ravel(), lam.ravel(), slacks])
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def problems():
    """[(name, ocp_ref, params_ref, ocp, params, [z...])]."""
    states = _states()
    out = []
    for name, kw in (("protocol", PROTOCOL), ("tro", TRO)):
        cfg_ref = OCP_ref.MPCConfig(**kw)
        ocp_ref = OCP_ref.OCP(cfg_ref)
        ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)),
                      device="cpu")
        for i, s in enumerate(states):
            mid, logw = _mid(s, i)
            if name == "tro":
                mid, logw = None, None
            p_ref = C_ref.build_params(ocp_ref, s, ENV, mid, logw)
            p = to_torch(p_ref)
            zs = [_z(cfg_ref, 100 * i + j) for j in range(2)]
            out.append((f"{name}-{i}", ocp_ref, p_ref, ocp, p, zs))
    return out


def test_sizes_match(problems):
    for _, ocp_ref, _, ocp, _, _ in problems:
        assert (ocp.cfg.n_z, ocp.n_eq, ocp.n_ineq) == \
            (ocp_ref.cfg.n_z, ocp_ref.n_eq, ocp_ref.n_ineq)
    ocp = problems[0][3]
    assert (ocp.cfg.n_z, ocp.n_eq, ocp.n_ineq) == (173, 144, 333)


def test_jitter_matches(problems):
    _, ocp_ref, _, ocp, _, _ = problems[0]
    for g, w in zip(ocp.jitter, ocp_ref.jitter):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_values(problems):
    for name, ocp_ref, p_ref, ocp, p, zs in problems:
        fns = jax.jit(lambda z, p: (
            ocp_ref.cost(z, p), ocp_ref.eq_residuals(z, p),
            ocp_ref.ineq_residuals(z, p),
            ocp_ref.rollout(p, *ocp_ref.unpack(z)[:2]),
            ocp_ref.infer_slacks(z, p)))
        for z in zs:
            f_w, ce_w, ci_w, (xr_w, xh_w), zi_w = fns(z, p_ref)
            zt = t(z)
            xr, xh = ocp.rollout(p, *ocp.unpack(zt)[:2])
            close(xr, xr_w, 1e-5, f"{name} X_rob")
            close(xh, xh_w, 1e-5, f"{name} X_hums")
            close(ocp.cost(zt, p), f_w, 1e-5, f"{name} cost")
            ce, ci = ocp.residuals(zt, p)
            close(ce, ce_w, 1e-5, f"{name} eq")
            close(ci, ci_w, 1e-5, f"{name} ineq")
            close(ocp.eq_residuals(zt, p), ce_w, 1e-5, f"{name} eq alone")
            close(ocp.ineq_residuals(zt, p), ci_w, 1e-5, f"{name} ineq alone")
            close(ocp.infer_slacks(zt, p), zi_w, 1e-5, f"{name} slacks")
            np.testing.assert_array_equal(ocp.pack(*ocp.unpack(zt)).numpy(), z)


def test_derivatives(problems):
    """The Jacobians (the reference takes them in forward mode; so does this
    check, and then the solver's reverse mode is held to the same numbers)
    and the Lagrangian Hessian the solver factors, at the protocol's
    problems. Where a model human lies within its radius of a wall's end
    point, the reference's second derivatives are NaN (jnp.maximum's
    derivative times sqrt's at 0), so its interior-point step is not
    finite; the port's must then be non-finite too, and is compared only
    elsewhere."""
    n_degenerate = 0
    for name, ocp_ref, p_ref, ocp, p, zs in problems:
        if not name.startswith("protocol"):
            continue
        rng = np.random.default_rng(7)
        y = rng.normal(0, 1, ocp.n_eq).astype(np.float32)
        lam = np.abs(rng.normal(0, 1, ocp.n_ineq)).astype(np.float32)

        def lag_ref(z, p):
            return (ocp_ref.cost(z, p) + jnp.dot(y, ocp_ref.eq_residuals(z, p))
                    + jnp.dot(lam, ocp_ref.ineq_residuals(z, p)))

        def lag(z):
            ce, ci = ocp.residuals(z, p)
            return ocp.cost(z, p) + torch.dot(t(y), ce) + torch.dot(t(lam), ci)

        ders = jax.jit(lambda z, p: (
            jax.grad(ocp_ref.cost)(z, p),
            jax.jacfwd(ocp_ref.eq_residuals)(z, p),
            jax.jacfwd(ocp_ref.ineq_residuals)(z, p),
            jax.hessian(lag_ref)(z, p)))
        for z in zs:
            g_w, je_w, ji_w, h_w = [np.asarray(x) for x in ders(z, p_ref)]
            zt = t(z)
            close(jacrev(ocp.cost)(zt, p), g_w, 1e-4, f"{name} grad")
            je, ji = jacfwd(ocp.residuals)(zt, p)
            close(je, je_w, 1e-4, f"{name} d eq")
            close(ji, ji_w, 1e-4, f"{name} d ineq")
            h = jacrev(jacrev(lag))(zt).numpy()
            assert np.isfinite(h).all() == np.isfinite(h_w).all(), name
            if not np.isfinite(h_w).all():
                n_degenerate += 1
                continue
            je, ji = jacrev(ocp.residuals)(zt, p)
            close(je, je_w, 1e-4, f"{name} d eq, reverse")
            close(ji, ji_w, 1e-4, f"{name} d ineq, reverse")
            err = np.abs(h - h_w).max()
            assert err <= 1e-3 * np.abs(h_w).max(), (name, err)
    # the inputs reach both cases
    assert 0 < n_degenerate < 4, n_degenerate

"""Parity of the port's interior-point solver (sicnav_tpu_torch.mpc.ipm)
with the JAX reference (sicnav_tpu.mpc.ipm).

Problems: a small convex QP with equality and inequality rows drawn from a
seed, and the bilevel OCP at the definitive protocol on hallway-bottleneck
states of host case 0, started on both sides from the same initial guess
(the port's feasible warmstart with inferred slacks) with the same problem
data (the reference's ``build_params``, forecast grids from a seed). The
reference's ``n_iter_dyn`` budget is a traced value, so one compiled
program runs both the one-iteration and the 30-iteration solves.

Tolerances:
- one IPM iteration from the same initial state: z and the slacks s within
  1e-4 of max(1, max |reference|) (the port differentiates in reverse mode
  and factors with another LAPACK: a few ulp in a 317 x 317 KKT solve).
  The multipliers y and lam come out of that solve rounding-bound: against
  the reference's own float64 run of the same iteration its float32 y is
  off by 2e-3 to 2e-2 of its largest entry. So the witness is that float64
  run of the reference: the port's float32 y and lam must lie within
  MULT_FACTOR times the reference's float32 distance from it, plus 1e-4
  (relative to max(1, max |witness|)). A port whose dual step is 0.9 of
  the right one fails this check (``test_one_iteration_catches_dual_fault``);
- a full 30-iteration solve, on instances where the reference ends with
  eq_viol < 1e-3: the objective and the first robot action within 1e-3
  (relative to max(1, |value|)); both sides' IPMInfo feasible alike
  (eq_viol < 1e-3, ineq_viol < 1e-2) and the same iteration count;
- a small QP with one curved equality row, under each of the solver's
  options (second-order correction, best-feasible fallback, early exit,
  geometric mu, no preconditioning with the objective's Hessian only):
  the solution and objective within 1e-4, the iteration counts equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import ipm as IPM_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import warmstart as WS

from tests.test_torch_mpc_ocp import ENV, PROTOCOL, _mid, close, t, to_torch

torch.set_num_threads(2)
SETTINGS = dict(n_iter=30)
MULT_FACTOR = 3


def test_settings_match():
    assert dataclasses.asdict(IPM.IPMSettings()) == \
        dataclasses.asdict(IPM_ref.IPMSettings())
    for h in (1, 2, 3, 5):
        for mid in (False, True):
            assert dataclasses.asdict(IPM.realtime_settings(h, mid)) == \
                dataclasses.asdict(IPM_ref.realtime_settings(h, mid))


def _qp(seed, n=6, m_e=2, m_i=4):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    Q = (A @ A.T + n * np.eye(n)).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    E = rng.normal(size=(m_e, n)).astype(np.float32)
    e = rng.normal(size=m_e).astype(np.float32)
    G = rng.normal(size=(m_i, n)).astype(np.float32)
    h = np.abs(rng.normal(size=m_i)).astype(np.float32)
    return Q, q, E, e, G, h


# the reference's solver options, each against its own run of the reference
VARIANTS = {
    "default": {},
    "soc": dict(soc=True),
    "best_feasible": dict(keep_best_feasible=True),
    "early_exit": dict(early_exit_tol=1e-4),
    "geometric_mu": dict(mu_schedule="geometric"),
    "plain": dict(precondition=False, exact_hessian=False),
}


@pytest.mark.parametrize("seed,variant", [(0, "default"), (1, "default")] +
                         [(2, v) for v in VARIANTS if v != "default"])
def test_small_qp(seed, variant):
    Q, q, E, e, G, h = _qp(seed)
    z0 = np.zeros(Q.shape[0], np.float32)
    kw = dict(n_iter=25, **VARIANTS[variant])
    st_ref, st = IPM_ref.IPMSettings(**kw), IPM.IPMSettings(**kw)
    # a curved equality row, so that the second-order correction has work
    want = jax.jit(lambda z0: IPM_ref.solve(
        lambda z: 0.5 * z @ Q @ z + q @ z,
        lambda z: jnp.concatenate([E @ z - e, z[:1] ** 2 + z[1:2] - 0.5]),
        lambda z: G @ z - h, z0, st_ref))(z0)
    Qt, qt, Et, et, Gt, ht = (t(x) for x in (Q, q, E, e, G, h))
    got = IPM.solve(lambda z: 0.5 * z @ Qt @ z + qt @ z,
                    lambda z: (torch.cat([Et @ z - et,
                                          z[:1] ** 2 + z[1:2] - 0.5]),
                               Gt @ z - ht), t(z0), st)
    close(got[0], want[0], 1e-4, "z")
    close(got[1].obj, want[1].obj, 1e-4, "obj")
    assert int(got[1].iters) == int(want[1].iters)


@pytest.fixture(scope="module")
def instances():
    """[(ocp_ref, params_ref, ocp, params, z0)] at host case 0's start and
    after six steps."""
    cfg_ref = OCP_ref.MPCConfig(**PROTOCOL)
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)), device="cpu")
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(ENV, 0)
    out = []
    for i in range(2):
        if i:
            for _ in range(6):
                s, _, _ = step(s, jnp.array([0.5, 0.05], jnp.float32), ENV)
        # the first with the constant-velocity sample grid build_params makes
        # without forecasts, the second with a grid drawn from a seed
        mid, logw = _mid(s, 20 + i) if i else (None, None)
        p_ref = jax.tree.map(jnp.asarray,
                             C_ref.build_params(ocp_ref, s, ENV, mid, logw))
        p = to_torch(p_ref)
        z0 = ocp.infer_slacks(WS.warmstart_horizon(ocp, p), p)
        out.append((ocp_ref, p_ref, ocp, p, z0.numpy()))
    return out


@pytest.fixture(scope="module")
def solve_ref():
    st = IPM_ref.IPMSettings(**SETTINGS)

    @jax.jit
    def run(p, z0, n):
        ocp_ref = OCP_ref.OCP(OCP_ref.MPCConfig(**PROTOCOL))
        return IPM_ref.solve(lambda z: ocp_ref.cost(z, p),
                             lambda z: ocp_ref.eq_residuals(z, p),
                             lambda z: ocp_ref.ineq_residuals(z, p), z0, st,
                             return_duals=True, n_iter_dyn=n)
    return run


def _solve(ocp, p, z0, n):
    return IPM.solve(lambda z: ocp.cost(z, p), lambda z: ocp.residuals(z, p),
                     torch.as_tensor(z0), IPM.IPMSettings(**SETTINGS),
                     return_duals=True, n_iter_dyn=n)


def _float64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64) if jnp.issubdtype(
        jnp.result_type(x), jnp.floating) else np.asarray(x), tree)


@pytest.fixture(scope="module")
def one_iteration(instances, solve_ref):
    """[(port inputs, reference's float32 (y, lam), its float64 (y, lam))]
    of one iteration on each instance."""
    out = []
    for ocp_ref, p_ref, ocp, p, z0 in instances:
        z_w, info_w, duals_w = solve_ref(p_ref, z0, 1)
        with jax.enable_x64(True):
            _, _, duals64 = solve_ref(_float64(p_ref), _float64(z0), 1)
            assert duals64[0].dtype == jnp.float64
        out.append(((ocp, p, z0), (z_w, info_w, duals_w),
                    [np.asarray(d, np.float64) for d in duals64[:2]]))
    return out


def _multiplier_errors(duals, duals_w, duals64):
    """[(name, the port's error, its bound)] of y and lam against the
    reference's float64 witness, relative to max(1, max |witness|)."""
    out = []
    for g, w, e, name in zip(duals[:2], duals_w[:2], duals64, ("y", "lam")):
        g, w = g.double().numpy(), np.asarray(w, np.float64)
        scale = max(1.0, np.abs(e).max())
        reach = np.abs(w - e).max() / scale
        out.append((name, np.abs(g - e).max() / scale,
                    MULT_FACTOR * reach + 1e-4))
    return out


def test_one_iteration(one_iteration):
    for (ocp, p, z0), (z_w, info_w, duals_w), duals64 in one_iteration:
        z, info, duals = _solve(ocp, p, z0, 1)
        close(z, z_w, 1e-4, "z")
        close(duals[2], duals_w[2], 1e-4, "s")
        assert int(info.iters) == int(info_w.iters) == 1
        for name, err, bound in _multiplier_errors(duals, duals_w, duals64):
            assert err <= bound, (name, err, bound)


def test_one_iteration_catches_dual_fault(one_iteration, monkeypatch):
    """The multiplier check fails a port whose dual step length a_d (the
    second _step_limit of an iteration) is 0.9 of the right one."""
    calls = [0]
    step_limit = IPM._step_limit

    def faulty(v, dv, tau):
        calls[0] += 1
        a = step_limit(v, dv, tau)
        return a * 0.9 if calls[0] % 2 == 0 else a

    monkeypatch.setattr(IPM, "_step_limit", faulty)
    for (ocp, p, z0), (_, _, duals_w), duals64 in one_iteration:
        _, _, duals = _solve(ocp, p, z0, 1)
        errs = _multiplier_errors(duals, duals_w, duals64)
        assert any(err > bound for _, err, bound in errs), errs


def test_full_solve(instances, solve_ref):
    n_checked = 0
    for ocp_ref, p_ref, ocp, p, z0 in instances:
        z_w, info_w, _ = solve_ref(p_ref, z0, SETTINGS["n_iter"])
        if not float(info_w.eq_viol) < 1e-3:
            continue
        n_checked += 1
        z, info, _ = _solve(ocp, p, z0, SETTINGS["n_iter"])
        close(info.obj, info_w.obj, 1e-3, "obj")
        close(ocp.unpack(z)[0][0], ocp_ref.unpack(z_w)[0][0], 1e-3,
              "first robot action")
        for i in (info, info_w):
            assert float(i.eq_viol) < 1e-3 and float(i.ineq_viol) < 1e-2, i
        assert int(info.iters) == int(info_w.iters) == SETTINGS["n_iter"]
    assert n_checked >= 1

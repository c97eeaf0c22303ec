"""Parity of the port's solver introspection (sicnav_tpu_torch.mpc.
introspection, ``ipm.solve(return_trace=True)``, ``campc_action(
debug=True)``) with the JAX reference's (sicnav_tpu.mpc.introspection).

Problems: MPC-CVMM's OCP (the plain controller of ``--policy
campc_cvmm``, T-RO robot) with one human, the smallest the controller
builds and the one whose reference control step compiles in under a
minute here, on hallway-bottleneck states of host case 0, both sides
started from the same guess with the same problem data (the reference's
``build_params``); the named-violation report also at the definitive
protocol's width (3 humans, the ORCA-KKT rows, the RA-L robot,
close-to-preds) on decision vectors drawn from a seed.

Tolerances:
- the trace's nine rows at the first iteration within 1e-4 of max(1,
  |reference|), as one IPM iteration is held in tests/test_torch_ipm.py;
  later iterations carry the multipliers' float32 rounding (see there),
  so of those only the iterate's own objective and violations are held,
  at 1e-3;
- the named violations within 1e-5 of max(1, |reference|) (the same
  float32 rows), the worst class and its row's text equal;
- a debug control step at one IPM iteration: the guess's cost and plan
  within 1e-5, the solution's within 1e-4, the cascade's choice equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import introspection as IN_ref
from sicnav_tpu.mpc import ipm as IPM_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import introspection as IN
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import warmstart as WS

from tests.test_torch_env import port_cfg
from tests.test_torch_mpc_ocp import PROTOCOL, _mid, _z, close, t, to_torch

torch.set_num_threads(2)
ENV1 = T_ref.EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                       human_num=1, max_humans=1, starts_moving=0,
                       time_limit=30, robot_kinematics="unicycle")
SMALL = dict(num_hums=1, num_walls=4, dt=0.25, priviledged_info=True,
             hum_model="cvmm")
TRACE_ITERS = 3


def _state(env, n_steps):
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(env, 0)
    for _ in range(n_steps):
        s, _, _ = step(s, jnp.array([0.5, 0.05], jnp.float32), env)
    return jax.tree.map(jnp.asarray, s)


@pytest.fixture(scope="module")
def small():
    """(ocp_ref, params_ref, ocp, params, z0) of the one-human problem
    after 8 steps toward the door."""
    cfg_ref = OCP_ref.MPCConfig(**SMALL)
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)), device="cpu")
    s = _state(ENV1, 8)
    p_ref = jax.tree.map(jnp.asarray, C_ref.build_params(ocp_ref, s, ENV1))
    p = to_torch(p_ref)
    z0 = ocp.infer_slacks(WS.warmstart_horizon(ocp, p), p)
    return ocp_ref, p_ref, ocp, p, z0


@pytest.fixture(scope="module")
def report_ref(small):
    """The reference's debug_solve_report of the small problem (its
    solve_with_debug compiled once, also read for the trace)."""
    ocp_ref, p_ref, _, _, z0 = small
    st = IPM_ref.IPMSettings(n_iter=TRACE_ITERS)
    return IN_ref.debug_solve_report(ocp_ref, p_ref, jnp.asarray(z0.numpy()),
                                     st)


def _hold_trace(rows, rows_ref, n):
    """rows: name -> (n,) of the port; rows_ref: the reference's."""
    assert set(rows) == set(IN.IterTrace._fields) == set(rows_ref)
    for name in IN.IterTrace._fields:
        got, want = np.asarray(rows[name]), np.asarray(rows_ref[name])
        assert got.shape == want.shape == (n,), (name, got.shape)
        close(got[:1], want[:1], 1e-4, f"{name} at the first iteration")
        if name in ("obj", "eq_viol", "ineq_viol"):
            close(got, want, 1e-3, f"{name} over the iterations")
        assert np.isfinite(got).all(), name


def test_solve_trace_matches_reference(small, report_ref):
    ocp_ref, p_ref, ocp, p, z0 = small
    st = IPM.IPMSettings(n_iter=TRACE_ITERS)
    z, info, raw = IPM.solve(lambda z: ocp.cost(z, p),
                             lambda z: ocp.residuals(z, p), z0, st,
                             return_trace=True)
    assert len(raw) == 9 and int(info.iters) == TRACE_ITERS
    _hold_trace(dict(zip(IN.IterTrace._fields, raw)),
                report_ref["iterations"], TRACE_ITERS)
    # the traced solve is the plain solve, and takes no budget
    z2, _ = IPM.solve(lambda z: ocp.cost(z, p),
                      lambda z: ocp.residuals(z, p), z0, st)
    assert torch.equal(z, z2)
    with pytest.raises(ValueError, match="n_iter_dyn"):
        IPM.solve(lambda z: ocp.cost(z, p), lambda z: ocp.residuals(z, p),
                  z0, st, return_trace=True, n_iter_dyn=2)
    # an early exit does not cut a traced solve, as in the reference
    early = dataclasses.replace(st, early_exit_tol=1e3,
                                early_exit_comp_tol=1e3)
    _, info_e, raw_e = IPM.solve(lambda z: ocp.cost(z, p),
                                 lambda z: ocp.residuals(z, p), z0, early,
                                 return_trace=True)
    assert int(info_e.iters) == TRACE_ITERS and raw_e[0].shape == (3,)
    assert int(IPM.solve(lambda z: ocp.cost(z, p),
                         lambda z: ocp.residuals(z, p), z0,
                         early)[1].iters) == 1


def test_debug_solve_report_matches_reference(small, report_ref):
    ocp_ref, p_ref, ocp, p, z0 = small
    got = IN.debug_solve_report(ocp, p, z0,
                                IPM.IPMSettings(n_iter=TRACE_ITERS))
    assert got.keys() == report_ref.keys()
    for key in ("info", "viol_guess", "viol_sol"):
        assert list(got[key]) == list(report_ref[key]), key
    for name, v in report_ref["viol_guess"].items():
        close(got["viol_guess"][name], v, 1e-5, f"guess {name}")
    for name, v in report_ref["viol_sol"].items():
        close(got["viol_sol"][name], v, 1e-3, f"solution {name}")
    assert got["worst"]["name"] == report_ref["worst"]["name"]
    assert got["worst"]["row"] == report_ref["worst"]["row"]
    close(got["worst"]["value"], report_ref["worst"]["value"], 1e-3, "worst")
    _hold_trace(got["iterations"], report_ref["iterations"], TRACE_ITERS)
    assert got["z_sol"].shape == report_ref["z_sol"].shape


@pytest.mark.parametrize("width", ["small", "protocol"])
def test_constraint_report_and_rows(small, width):
    """Every class's largest violation and its row, named as the
    reference names it, on decision vectors drawn from a seed."""
    if width == "small":
        ocp_ref, p_ref, ocp, p, _ = small
    else:
        cfg_ref = OCP_ref.MPCConfig(**PROTOCOL)
        ocp_ref = OCP_ref.OCP(cfg_ref)
        ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)),
                      device="cpu")
        s = _state(_protocol_env(), 12)
        mid, lw = _mid(s, 3)
        p_ref = jax.tree.map(jnp.asarray,
                             C_ref.build_params(ocp_ref, s, _protocol_env(),
                                                mid, lw))
        p = to_torch(p_ref)
    rep_fn = jax.jit(lambda z, p: IN_ref.constraint_report(ocp_ref, z, p))
    names = set()
    for seed in range(3):
        z = _z(ocp_ref.cfg, 50 + seed)
        want = rep_fn(z, p_ref)
        got = IN.constraint_report(ocp, t(z), p)
        assert list(got) == list(want)
        for name, gv in want.items():
            close(got[name].max_viol, gv.max_viol, 1e-5, name)
            if float(gv.max_viol) > 1e-3:     # a row that stands out
                assert int(got[name].arg_flat) == int(gv.arg_flat), name
                assert (IN.describe_row(ocp, name, int(gv.arg_flat)) ==
                        IN_ref.describe_row(ocp_ref, name,
                                            int(gv.arg_flat)))
                names.add(name)
        worst = IN.argmax_violated(got)
        worst_w = IN_ref.argmax_violated(want)
        assert worst[0] == worst_w[0] and worst[2] == worst_w[2]
        assert (IN.describe_row(ocp, worst[0], worst[2]) ==
                IN_ref.describe_row(ocp_ref, *worst_w[::2]))
    assert len(names) >= (2 if width == "small" else 4), names
    for name in ("coll", "other"):
        assert (IN.describe_row(ocp, name, 1) ==
                IN_ref.describe_row(ocp_ref, name, 1))


def _protocol_env():
    return T_ref.EnvConfig(scenario="hallway_bottleneck",
                           human_policy="orca_plus", human_num=3,
                           max_humans=3, starts_moving=0, time_limit=30,
                           robot_kinematics="unicycle")


def test_campc_debug_step_matches_reference(small):
    """One debug control step at one IPM iteration from a fresh carry."""
    ocp_ref, _, ocp, _, _ = small
    s = _state(ENV1, 8)
    st_ref, st = IPM_ref.IPMSettings(n_iter=1), IPM.IPMSettings(n_iter=1)
    act = jax.jit(C_ref.campc_action, static_argnames=(
        "ocp", "env_cfg", "settings", "debug", "aux"))
    a_w, carry_w, dbg_w = act(ocp_ref, s, C_ref.init_carry(ocp_ref), ENV1,
                              st_ref, debug=True)
    a, carry, dbg = C.campc_action(ocp, to_torch(s), C.init_carry(ocp),
                                   port_cfg(ENV1), st, debug=True)
    assert isinstance(dbg, IN.SolveDebug)
    assert bool(dbg.used_guess) == bool(dbg_w.used_guess)
    assert bool(carry.prev_ok) == (not bool(dbg.used_guess))
    close(a, a_w, 1e-4, "action")
    close(dbg.guess_cost, dbg_w.guess_cost, 1e-5, "guess cost")
    close(dbg.guess_plan, dbg_w.guess_plan, 1e-5, "guess plan")
    close(dbg.sol_cost, dbg_w.sol_cost, 1e-4, "solution cost")
    close(dbg.plan, dbg_w.plan, 1e-4, "plan")
    close(dbg.human_plans, dbg_w.human_plans, 1e-4, "human plans")
    close(dbg.slack_max, dbg_w.slack_max, 1e-4, "slack max")
    for name in ("obj", "eq_viol", "ineq_viol", "comp"):
        close(getattr(dbg.info, name), getattr(dbg_w.info, name), 1e-4, name)
    assert int(dbg.info.iters) == int(dbg_w.info.iters) == 1
    for name in IN.IterTrace._fields:
        close(getattr(dbg.trace, name), getattr(dbg_w.trace, name), 1e-4,
              f"trace {name}")
    for rep, rep_w in ((dbg.viol_sol, dbg_w.viol_sol),
                       (dbg.viol_used, dbg_w.viol_used)):
        assert list(rep) == list(rep_w)
        for name, gv in rep_w.items():
            close(rep[name].max_viol, gv.max_viol, 1e-4, name)
    # the debug path never escalates, as in the reference
    ocp_ae = OCP.OCP(dataclasses.replace(ocp.cfg, adaptive_effort=3),
                     device="cpu")
    failed = C.init_carry(ocp_ae)._replace(
        has_prev=torch.tensor(True), prev_ok=torch.tensor(False))
    _, _, dbg_ae = C.campc_action(ocp_ae, to_torch(s), failed,
                                  port_cfg(ENV1), st, debug=True)
    assert int(dbg_ae.info.iters) == 1 and dbg_ae.trace.obj.shape == (1,)

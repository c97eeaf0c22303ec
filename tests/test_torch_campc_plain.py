"""Parity of the port's plain SICNav controllers (``--policy campc``,
``campc_cvmm``: sicnav_tpu_torch.mpc.campc without forecasts) with the JAX
reference's. The batched plain controller is held to its unbatched self in
tests/test_torch_campc_plain_batch.py.

- MPC-CVMM's OCP (``hum_model="cvmm"``) at the protocol's width (3
  humans, 4 walls) on host case 0 at its start and after 14 steps, T-RO
  and RA-L, privileged or not: ``build_params`` and the OCP's values
  within 1e-5, its first derivatives within 1e-4 (tests/
  test_torch_mpc_ocp.py's rule: the port differentiates in reverse mode).
- Three control steps of plain SICNav-p (the ORCA-KKT controller with
  privileged information and the RA-L robot, as ``scripts/
  eval_suite_torch.py --policy campc --privileged`` builds it, at its
  real-time budget of 15 IPM iterations), driven by the reference: both
  sides get the same state and carry at every step. The rule of tests/
  test_torch_campc_steps.py: action and cascade choice within 1e-3, or
  float32 rounding moves the port's own action by at least a tenth of
  the disagreement (its float64 run of the same step); two of the three
  steps must agree within 1e-3. The reference's controller takes about
  two minutes to trace and compile here, most of this file's time.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import ipm as IPM_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP

from tests.test_torch_env import port_cfg
from tests.test_torch_mpc_ocp import ENV, TRO, _z, close, t, to_torch

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import eval_suite_torch as ES  # noqa: E402

STEPS = 3
TOL = 1e-3
RAL = dict(TRO, robot_nx=8, robot_capsule=True, term_q_coeff=75.0,
           slack_mode="acados")


def _plain_cfg():
    """The MPCConfig of ``eval_suite_torch.py --policy campc --privileged``
    at the protocol."""
    args = ES.parse_args(["--policy", "campc", "--privileged"])
    return ES.campc_config(args, ES.env_config(args))


def _f64(tree):
    return CS.tree_map(lambda x: x.double() if x.is_floating_point() else x,
                       tree)


def _ref_states():
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(ENV, 0)
    out = [s]
    for _ in range(14):
        s, _, _ = step(s, jnp.array([0.6, 0.0], jnp.float32), ENV)
    return out + [s]


@pytest.mark.parametrize("robot", ["tro", "ral"])
def test_cvmm_ocp_matches_reference(robot):
    states = _ref_states()
    env = port_cfg(ENV)
    for priv in (False, True):
        kw = dict(RAL if robot == "ral" else TRO, hum_model="cvmm",
                  priviledged_info=priv)
        cfg_ref = OCP_ref.MPCConfig(**kw)
        ocp_ref = OCP_ref.OCP(cfg_ref)
        ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)),
                      device="cpu")
        assert not cfg_ref.kkt and ocp.n_eq == ocp_ref.n_eq == 0
        assert ocp.n_ineq == ocp_ref.n_ineq
        fns = jax.jit(lambda z, p: (
            ocp_ref.cost(z, p), ocp_ref.ineq_residuals(z, p),
            jax.grad(ocp_ref.cost)(z, p),
            jax.jacfwd(ocp_ref.ineq_residuals)(z, p)))
        bp = jax.jit(lambda s: C_ref.build_params(ocp_ref, s, ENV))
        for i, s in enumerate(states):
            p_ref = bp(s)
            p = C.build_params(ocp, to_torch(s), env)
            for name, g, w in zip(p_ref._fields, p, p_ref):
                if name == "cost_w":
                    for gg, ww in zip(g, w):
                        close(gg, ww, 1e-5, name)
                else:
                    close(g, w, 1e-5, f"{robot} priv={priv} {name}")
            p = to_torch(p_ref)
            for j in range(2):
                z = _z(cfg_ref, 10 * i + j)
                f_w, ci_w, g_w, ji_w = fns(z, p_ref)
                zt = t(z)
                where = f"{robot} priv={priv} state {i}"
                close(ocp.cost(zt, p), f_w, 1e-5, f"{where} cost")
                ce, ci = ocp.residuals(zt, p)
                assert ce.shape == (0,)
                close(ci, ci_w, 1e-5, f"{where} ineq")
                close(jacrev(ocp.cost)(zt, p), g_w, 1e-4, f"{where} grad")
                close(jacrev(lambda z: ocp.residuals(z, p)[1])(zt), ji_w,
                      1e-4, f"{where} d ineq")


def test_plain_sicnav_p_steps_match_reference():
    cfg = _plain_cfg()
    assert cfg.priviledged_info and cfg.robot_nx == 8 and not cfg.door_yield
    assert cfg.wall_margin == 0.05 and cfg.hum_model == "orca_casadi_kkt"
    cfg_ref = OCP_ref.MPCConfig(**dataclasses.asdict(cfg))
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp, _ = C.make_policy(port_cfg(ENV), cfg, device="cpu")
    settings_ref = IPM_ref.realtime_settings(3)
    settings = IPM.realtime_settings(3)
    assert settings.n_iter == settings_ref.n_iter == 15
    env = port_cfg(ENV)
    act_ref = jax.jit(C_ref.campc_action,
                      static_argnames=("ocp", "env_cfg", "settings", "debug",
                                       "aux"))
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = jax.tree.map(jnp.asarray, CS_ref.reset_host(ENV, 0))
    carry = C_ref.init_carry(ocp_ref)
    agreed = []
    for k in range(STEPS):
        a_w, carry_w = act_ref(ocp_ref, s, carry, ENV, settings_ref)
        st, carry_t = to_torch(s), C.CAMPCCarry(*[t(x) for x in carry])
        a, carry_p, aux = C.campc_action(ocp, st, carry_t, env, settings,
                                         aux=True)
        assert bool(carry_p.prev_ok) == (not bool(aux.use_guess))
        a_w = np.asarray(a_w, np.float64)
        err = np.abs(a.double().numpy() - a_w).max()
        if err <= TOL and bool(carry_p.prev_ok) == bool(carry_w.prev_ok):
            agreed.append(k)
        else:
            a64, _ = C.campc_action(ocp, _f64(st), _f64(carry_t), env,
                                    settings)
            reach = np.abs(a.double().numpy() - a64.numpy()).max()
            assert reach >= 0.1 * err, (k, err, reach)
        s, _, _ = step_ref(s, jnp.asarray(a_w, jnp.float32), ENV)
        carry = carry_w
    assert len(agreed) >= 2, agreed

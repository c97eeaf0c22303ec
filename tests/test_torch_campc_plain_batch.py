"""The port's batched plain SICNav controller (``campc.make_policy(
batch=True)``, ``torch.func.vmap`` of ``campc_action`` over the episodes)
against its unbatched self; its unbatched step is held to the JAX
reference in tests/test_torch_campc_plain.py.

- Plain SICNav-p (as ``scripts/eval_suite_torch.py --policy campc
  --privileged`` builds it) in float64 at B = 2 (host cases 0 and 1 after
  two DWA steps) and 3 IPM iterations: actions and the solve's violations
  within 1e-6 of each episode's unbatched step, cascade flags equal.
- The same with ``adaptive_effort`` on a carry whose previous solve failed
  in one episode and succeeded in the other: each episode gets its own
  iteration budget, as alone (the reference's while loop under
  ``jax.vmap``), with no host read.
- ``ipm.solve`` with a tensor iteration budget under a static bound gives
  what the host budget gives, alone and vmapped, on a small QP.
"""

import dataclasses

import pytest
import torch

from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.policies import dwa as D

from tests.test_torch_campc_plain import _f64, _plain_cfg
from tests.test_torch_env import port_cfg
from tests.test_torch_ipm import _qp
from tests.test_torch_mpc_ocp import ENV, t

torch.set_num_threads(2)
ACTION_TOL = 1e-6
CASCADE = ("use_guess", "sol_feasible", "sol_realistic", "cost_worse",
           "braked", "rescued")


@pytest.fixture(scope="module")
def batch_inputs():
    """States of host cases 0 and 1 after two DWA steps, and their carries
    after one batched plain step (3 IPM iterations), in float64."""
    env = port_cfg(ENV)
    states = CS.reset_batch(env, [0, 1], device="cpu")
    for _ in range(2):
        states, _, _ = CS.step_masked(states, D.dwa_policy_batch(states, env),
                                      env)
    states = _f64(states)
    ocp, init_fn, step_fn = C.make_policy(env, _plain_cfg(),
                                          IPM.IPMSettings(n_iter=3),
                                          device="cpu", batch=True)
    assert ocp.vmapped
    carries = _f64(init_fn([0, 1]))
    assert carries.z_prev.shape == (2, ocp.cfg.n_z)
    _, carries = step_fn(states, carries)
    return env, states, carries


def _batched_vs_single(cfg, env, states, carries, n_iter=3):
    settings = IPM.IPMSettings(n_iter=n_iter)
    _, _, step_fn = C.make_policy(env, cfg, settings, device="cpu",
                                  batch=True, aux=True)
    a_b, carry_b, aux_b = step_fn(states, carries)
    assert a_b.dtype == torch.float64 and a_b.shape == (2, 2)
    ocp = OCP.OCP(cfg, device="cpu")
    for i in range(2):
        one = [CS.tree_map(lambda x: x[i], x) for x in (states, carries)]
        a_i, carry_i, aux_i = C.campc_action(ocp, *one, env, settings,
                                             aux=True)
        torch.testing.assert_close(a_b[i], a_i, rtol=0, atol=ACTION_TOL)
        for name in CASCADE:
            assert bool(getattr(aux_b, name)[i] == getattr(aux_i, name)), name
        for name in ("prev_ok", "num_prev_used", "door_stall"):
            assert bool(getattr(carry_b, name)[i] == getattr(carry_i, name))
        for name in ("eq_viol", "ineq_viol"):
            torch.testing.assert_close(getattr(aux_b, name)[i],
                                       getattr(aux_i, name), rtol=0,
                                       atol=ACTION_TOL)
        torch.testing.assert_close(carry_b.z_prev[i], carry_i.z_prev,
                                   rtol=0, atol=1e-5)
    return a_b, aux_b


def test_batched_plain_step_equals_per_episode(batch_inputs):
    env, states, carries = batch_inputs
    a, _ = _batched_vs_single(_plain_cfg(), env, states, carries)
    assert bool(torch.isfinite(a).all())


def test_batched_adaptive_effort_equals_per_episode(batch_inputs):
    """Episode 0's previous solve failed (2 more iterations), episode 1's
    succeeded: each gets its own budget, as alone."""
    env, states, carries = batch_inputs
    carries = carries._replace(prev_ok=torch.tensor([False, True]))
    cfg = dataclasses.replace(_plain_cfg(), adaptive_effort=2)
    a_ae, aux_ae = _batched_vs_single(cfg, env, states, carries)
    a_no, aux_no = _batched_vs_single(_plain_cfg(), env, states, carries)
    # the budget reached episode 0's solve only
    assert abs(aux_ae.eq_viol[0] - aux_no.eq_viol[0]) > ACTION_TOL
    torch.testing.assert_close(a_ae[1], a_no[1], rtol=0, atol=0)
    torch.testing.assert_close(aux_ae.eq_viol[1], aux_no.eq_viol[1], rtol=0,
                               atol=0)


@pytest.mark.parametrize("variant", [{}, dict(keep_best_feasible=True),
                                     dict(early_exit_tol=1e-4)])
def test_tensor_budget_equals_host_budget(variant):
    """ipm.solve with a tensor n_iter_dyn under a static bound gives what
    the host budget gives, alone and vmapped over budgets."""
    Q, q, E, e, G, h = (t(x) for x in _qp(4))
    st = IPM.IPMSettings(n_iter=4, **variant)

    def run(n, bound=None):
        return IPM.solve(lambda z: 0.5 * z @ Q @ z + q @ z,
                         lambda z: (E @ z - e, G @ z - h),
                         torch.zeros(Q.shape[0]), st, n_iter_dyn=n,
                         n_iter_bound=bound)

    with pytest.raises(ValueError, match="n_iter_bound"):
        run(torch.tensor(2))
    outs = torch.func.vmap(lambda n: run(n, 6))(
        torch.tensor([2, 6], dtype=torch.int32))
    for i, n in enumerate((2, 6)):
        z_h, info_h = run(n)
        z_t, info_t = run(torch.tensor(n, dtype=torch.int32), 6)
        torch.testing.assert_close(z_t, z_h, rtol=0, atol=0)
        assert int(info_t.iters) == int(info_h.iters)
        torch.testing.assert_close(outs[0][i], z_h, rtol=0, atol=1e-6)
        assert int(outs[1].iters[i]) == int(info_h.iters)

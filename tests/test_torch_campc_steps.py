"""Per-step parity of the port's fused controller (sicnav_tpu_torch.mpc.
sicnav_diffusion.act_on_forecasts -> campc.campc_action) with the JAX
reference's (sicnav_tpu.mpc.campc.campc_action, composed as
sicnav_tpu.mpc.sicnav_diffusion.sicnav_diffusion_action composes it).

Ten consecutive control steps of host case 0 at the definitive protocol,
driven by the reference: at each step both sides get the same state, the
same controller carry (the reference's) and the same served forecasts (the
port's trained JMID forecaster's, injected on both sides, so the ranking's
rounding never decides what is compared); the reference's action steps the
episode on. The controller is ``make_policy``'s fused configuration with
its own solver budget (the MID-conditioned real-time cap, 15 IPM
iterations; the protocol's 30 are held in tests/test_torch_ipm.py).

Tolerances. The door-yield latch and counter, decided before the solve,
are equal on every step. The action (v, r) and the cascade's decision
(solution or guess) must agree within 1e-3 on a step that float32 decides.
A solve that 15 iterations leave unconverged carries float32 rounding
(1e-6 after one iteration, tests/test_torch_ipm.py) into the action at
1e-3 to 1e-2, and can move its eq_viol across the cascade's 0.1 threshold.
So a step where the two sides differ by more is held to the port's own
float64 run of the same step: the port's float32 result must lie at least
a tenth of the disagreement away from it, that is, float32 rounding moves
the port's action by the order of the disagreement (a port that computes
something else is as far from the reference in float64 as in float32, and
fails). At least six of the ten steps must agree within 1e-3, on both
cascade branches.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import ipm as IPM_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu.mpc import sicnav_diffusion as SD_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion.mid import JMIDModel
from sicnav_tpu_torch.diffusion.models import ModelConfig
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

from tests.test_torch_env import port_cfg
from tests.test_torch_mpc_ocp import ENV, PROTOCOL, t, to_torch

torch.set_num_threads(2)
STEPS = 10
TOL = 1e-3
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "jmid_hallway.npz")


def _float64(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_float64(x) for x in tree])
    return tree.double() if tree.is_floating_point() else tree


def _mpc_inputs_ref(forecasts, log_w, s):
    """The reference's sicnav_diffusion_action body between the forecaster
    and campc_action."""
    goals = SD_ref.weighted_goals(forecasts, log_w)
    mid = jnp.transpose(forecasts, (1, 0, 2, 3))[:, :, :6]
    return s._replace(h_goal=goals), mid, log_w[0], s.h_goal


def test_control_steps_match_reference():
    cfg_ref = OCP_ref.MPCConfig(**PROTOCOL)
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)), device="cpu")
    env = port_cfg(ENV)
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=0.25)
    settings_ref = IPM_ref.realtime_settings(3, with_mid=True)
    settings = IPM.realtime_settings(3, with_mid=True)
    assert settings.n_iter == settings_ref.n_iter == 15
    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), device="cpu")
    model.load_state_dict(convert.load_npz(WEIGHTS))
    gen = torch.Generator().manual_seed(0)

    act_ref = jax.jit(C_ref.campc_action,
                      static_argnames=("ocp", "env_cfg", "settings", "debug",
                                       "aux"))
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = jax.tree.map(jnp.asarray, CS_ref.reset_host(ENV, 0))
    carry = C_ref.init_carry(ocp_ref)
    fstate = FC.init_state(3, fcfg, device="cpu")
    agreed = []
    for k in range(STEPS):
        st = to_torch(s)
        fstate = FC.update_state_hists(fstate, st, fcfg)
        fc, lw = FC.predict_ret_best(model, fstate, st, fcfg, generator=gen)
        view, mid, lw0, intent = _mpc_inputs_ref(jnp.asarray(fc.numpy()),
                                                 jnp.asarray(lw.numpy()), s)
        a_w, carry_w, aux_w = act_ref(ocp_ref, view, carry, ENV, settings_ref,
                                      mid_samples=mid, mid_logw0=lw0,
                                      aux=True, h_intent=intent)
        carry_t = C.CAMPCCarry(*[t(x) for x in carry])
        a, carry_p, aux = SD.act_on_forecasts(ocp, st, carry_t, fc, lw, env,
                                              settings, aux=True)
        where = f"step {k}"
        assert bool(carry_p.door_latch) == bool(carry_w.door_latch), where
        assert int(carry_p.door_stall) == int(carry_w.door_stall), where
        assert bool(carry_p.prev_ok) == (not bool(aux.use_guess)), where
        a_w = np.asarray(a_w, np.float64)
        err = np.abs(a.double().numpy() - a_w).max()
        same = bool(aux.use_guess) == bool(aux_w.use_guess)
        if err <= TOL and same:
            agreed.append(bool(aux_w.use_guess))
        else:
            a64, _ = SD.act_on_forecasts(ocp, _float64(st), _float64(carry_t),
                                         fc.double(), lw.double(), env,
                                         settings)
            reach = np.abs(a.double().numpy() - a64.numpy()).max()
            assert reach >= 0.1 * err, (where, err, reach, same)
        s, _, _ = step_ref(s, jnp.asarray(a_w, jnp.float32), ENV)
        carry = carry_w
    assert len(agreed) >= 6, agreed
    assert True in agreed and False in agreed, agreed

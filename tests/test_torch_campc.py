"""Parity of the port's controller (sicnav_tpu_torch.mpc.warmstart, campc,
sicnav_diffusion) with the JAX reference (sicnav_tpu.mpc).

Inputs: hallway-bottleneck states of host case 0 at the definitive
protocol (3 humans in 3 slots, all starting at once), forecast grids drawn
from a seed, and door-yield scenes built by hand (a robot stalled below the
door mouth with transiting, parked and following humans). The controller
is the fused SICNav-Diffusion configuration of ``make_policy`` (RA-L
capsule robot, acados slacks, close-to-preds, door-yield, wall margin
0.10). Per-step parity of whole control steps is in
tests/test_torch_campc_steps.py.

Tolerance: build_params, the door-yield geometry, the warmstart, the
exact human rollout, the multi-start guesses, the evasive brake and the
wall clearance within 1e-5 of max(1, max |reference|) (the same float32
operations); the door-yield booleans and counters equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.mpc import campc as C_ref
from sicnav_tpu.mpc import ocp as OCP_ref
from sicnav_tpu.mpc import sicnav_diffusion as SD_ref
from sicnav_tpu.mpc import warmstart as WS_ref
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion.mid import JMIDModel
from sicnav_tpu_torch.diffusion.models import ModelConfig
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm as IPM
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
from sicnav_tpu_torch.mpc import warmstart as WS

from tests.test_torch_env import port_cfg
from tests.test_torch_mpc_ocp import ENV, PROTOCOL, _mid, close, t, to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ocps():
    cfg_ref = OCP_ref.MPCConfig(**PROTOCOL)
    return (OCP_ref.OCP(cfg_ref),
            OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)),
                    device="cpu"))


def _states(n_steps=(0, 6, 14)):
    step = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    s = CS_ref.reset_host(ENV, 0)
    out = []
    for k in range(max(n_steps) + 1):
        if k in n_steps:
            out.append(s)
        s, _, _ = step(s, jnp.array([0.55, 0.02], jnp.float32), ENV)
    return out


def test_build_params(ocps):
    ocp_ref, ocp = ocps
    env = port_cfg(ENV)
    fn = jax.jit(lambda s, mid, lw, use, pocket: C_ref.build_params(
        ocp_ref, s, ENV, mid, lw, goal_override=(use, pocket)))
    for i, s in enumerate(_states()):
        mid, lw = _mid(s, 40 + i)
        for use in (False, True):
            pocket = np.array([0.6, -0.9], np.float32)
            want = fn(s, mid, lw, use, pocket)
            got = C.build_params(ocp, to_torch(s), env, t(mid), t(lw),
                                 goal_override=(torch.tensor(use), t(pocket)))
            for name, g, w in zip(want._fields, got, want):
                if name == "cost_w":
                    for gg, ww in zip(g, w):
                        close(gg, ww, 1e-5, name)
                else:
                    close(g, w, 1e-5, name)


def test_build_params_without_forecasts():
    """The T-RO view without a forecast grid: the constant-velocity grid."""
    cfg_ref = OCP_ref.MPCConfig(num_hums=3, num_walls=4, num_mid_samples=4)
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)), device="cpu")
    s = _states((6,))[0]
    want = jax.jit(lambda s: C_ref.build_params(ocp_ref, s, ENV))(s)
    got = C.build_params(ocp, to_torch(s), port_cfg(ENV))
    for name, g, w in zip(want._fields, got, want):
        if name != "cost_w":
            close(g, w, 1e-5, name)


def _door_scenes():
    """(state, intent) pairs of the reference's door-yield scenario, with a
    third human far up the hallway."""
    s = CS_ref.reset_host(ENV, 0)
    stalled = s._replace(
        r_pos=jnp.array([0.0, -0.45]), r_goal=jnp.array([0.0, 3.0]),
        r_vel=jnp.zeros(2), h_mask=jnp.array([True, True, True]),
        h_pos=jnp.array([[-0.15, 0.2], [0.8, 2.0], [-0.6, 3.0]]))
    moving = stalled._replace(r_vel=jnp.array([0.0, 0.8]))
    clear = moving._replace(h_pos=jnp.array([[-0.9, 1.5], [0.8, 2.0],
                                             [-0.6, 3.0]]))
    through = stalled._replace(r_pos=jnp.array([0.0, 0.5]))
    est = {"moving": jnp.array([[-0.15, -2.0], [0.8, 2.5], [-0.6, 3.5]]),
           "parked": jnp.array([[-0.15, 0.2], [0.8, 2.5], [-0.6, 3.5]]),
           "follow": jnp.array([[-0.15, 2.0], [0.8, 2.5], [-0.6, 3.5]])}
    return [(stalled, est["moving"]), (moving, est["moving"]),
            (clear, est["moving"]), (stalled, est["parked"]),
            (stalled, est["follow"]), (through, est["moving"])]


@pytest.mark.parametrize("stall_steps", [0, 4])
def test_door_yield_update(stall_steps):
    """Sequences of door-yield updates through every branch: the stall
    trigger, the latch, its release, the timeout and the cooldown."""
    cfg_ref = OCP_ref.MPCConfig(**dict(PROTOCOL, door_yield_stall=stall_steps))
    cfg = OCP.MPCConfig(**dataclasses.asdict(cfg_ref))
    upd = jax.jit(lambda s, e, st, la: C_ref.door_yield_update(
        s, e, cfg_ref, st, la))
    scenes = _door_scenes()
    fired = 0
    for start in [(0, False), (3, True), (cfg.door_yield_hold_max - 1, True),
                  (-cfg.door_yield_cooldown, False)]:
        st_w, la_w = jnp.int32(start[0]), jnp.array(start[1])
        st, la = torch.tensor(start[0], dtype=torch.int32), \
            torch.tensor(start[1])
        for k in range(12):
            s, e = scenes[(k * 5 + start[0]) % len(scenes)] if k % 3 else \
                scenes[0]
            up_w, pocket_w, st_w, la_w = upd(s, e, st_w, la_w)
            up, pocket, st, la = C.door_yield_update(to_torch(s), t(e), cfg,
                                                     st, la)
            assert bool(up) == bool(up_w)
            assert int(st) == int(st_w) and bool(la) == bool(la_w)
            close(pocket, pocket_w, 1e-5, "pocket")
            fired += int(bool(up))
    assert fired > 0


@pytest.fixture(scope="module")
def problems(ocps):
    ocp_ref, ocp = ocps
    out = []
    for i, s in enumerate(_states((0, 14))):
        mid, lw = _mid(s, 60 + i)
        p_ref = jax.tree.map(jnp.asarray,
                             C_ref.build_params(ocp_ref, s, ENV, mid, lw))
        out.append((p_ref, to_torch(p_ref)))
    return out


def test_warmstart_horizon(ocps, problems):
    ocp_ref, ocp = ocps
    ws = jax.jit(lambda p: (WS_ref.warmstart_horizon(ocp_ref, p),
                            ocp_ref.infer_slacks(
                                WS_ref.warmstart_horizon(ocp_ref, p), p)))
    for p_ref, p in problems:
        z_w, zi_w = ws(p_ref)
        z = WS.warmstart_horizon(ocp, p)
        close(z, z_w, 1e-5, "warmstart z")
        close(ocp.infer_slacks(z, p), zi_w, 1e-5, "with slacks")


def test_exact_rollout_and_margin(ocps, problems):
    ocp_ref, ocp = ocps
    fn = jax.jit(lambda p, u: (WS_ref.plan_human_rollout(ocp_ref, p, u),
                               C_ref.exact_plan_margin(ocp_ref, p, u),
                               C_ref.exact_plan_margin(ocp_ref, p, u, 2)))
    rng = np.random.default_rng(5)
    for p_ref, p in problems:
        u = np.stack([rng.uniform(0.2, 0.8, 4), rng.uniform(-0.5, 0.5, 4)],
                     -1).astype(np.float32)
        roll_w, m_w, m2_w = fn(p_ref, u)
        roll = WS.plan_human_rollout(ocp, p, t(u))
        for g, w, name in zip(roll, roll_w, ("X_rob", "X_hums", "u_hums",
                                             "lam")):
            close(g, w, 1e-5, name)
        close(C.exact_plan_margin(ocp, p, t(u)), m_w, 1e-5, "margin")
        close(C.exact_plan_margin(ocp, p, t(u), 2), m2_w, 1e-5, "margin 2")


def test_fused_action_is_forecast_then_mpc():
    """sicnav_diffusion_action = the forecaster's served forecasts, then
    act_on_forecasts; make_policy builds the protocol's controller."""
    env = port_cfg(ENV)
    model = JMIDModel(ModelConfig(context_dim=32, enc_rnn_dim=16, tf_layer=1,
                                  n_heads=4), device="cpu")
    fcfg = FC.ForecasterConfig(num_samples=8, num_ret_samples=4, dt=0.25,
                               ddim_stride=25)
    ocp, policy = SD.make_policy(env, model, fcfg=fcfg,
                                 settings=IPM.IPMSettings(n_iter=2),
                                 device="cpu")
    cfg_ref = OCP_ref.MPCConfig(**dict(PROTOCOL, num_mid_samples=4))
    assert dataclasses.asdict(ocp.cfg) == dataclasses.asdict(cfg_ref)
    s = CS.reset_host(env, 0, device="cpu")
    carry = SD.init_carry(ocp, 3, fcfg, seed=3)
    a, carry2 = policy(s, carry)
    fstate = FC.update_state_hists(carry.forecaster, s, fcfg)
    fc, lw = FC.predict_ret_best(model, fstate, s, fcfg,
                                 generator=torch.Generator().manual_seed(3))
    a2, _ = SD.act_on_forecasts(ocp, s, carry.mpc, fc, lw, env,
                                IPM.IPMSettings(n_iter=2))
    np.testing.assert_array_equal(a.numpy(), a2.numpy())
    np.testing.assert_array_equal(carry2.forecaster.hist.numpy(),
                                  fstate.hist.numpy())
    goals_w = SD_ref.weighted_goals(jnp.asarray(fc.numpy()),
                                    jnp.asarray(lw.numpy()))
    close(SD.weighted_goals(fc, lw), goals_w, 1e-5, "goals")


# the reference's cascade options, off on the protocol's path
OPTIONS = dict(multi_start=4, rescue_best_margin=True, evasive_brake=True,
               wall_aware_realism=True, brake_horizon=2, adaptive_effort=1)


def test_starts_and_brake(problems):
    """The cascade options' parts against the reference's twins: the four
    multi-start guesses (the selected, fresh, brake-profile and side-step
    starts) from a fresh carry and from one whose shifted previous solution
    is taken, the evasive brake fan's action, the wall clearance of a
    rollout and the guess margin at brake_horizon."""
    cfg_ref = OCP_ref.MPCConfig(**dict(PROTOCOL, **OPTIONS))
    ocp_ref = OCP_ref.OCP(cfg_ref)
    ocp = OCP.OCP(OCP.MPCConfig(**dataclasses.asdict(cfg_ref)), device="cpu")

    def ref(carry, p, u):
        Xr, _ = WS_ref.exact_human_rollout(ocp_ref, p, u)
        return (C_ref._build_starts(ocp_ref, carry, p),
                C_ref._evasive_brake_action(ocp_ref, p), Xr,
                C_ref._min_wall_clearance(p, Xr),
                C_ref.exact_plan_margin(ocp_ref, p, u, cfg_ref.brake_horizon))

    ref = jax.jit(ref)
    rng = np.random.default_rng(9)
    shifted = 0
    for p_ref, p in problems:
        fresh = C_ref.init_carry(ocp_ref)
        z_prev = ocp_ref.infer_slacks(WS_ref.warmstart_horizon(ocp_ref, p_ref),
                                      p_ref)
        # the world as the previous plan predicted it: the shift is taken
        prev = fresh._replace(
            z_prev=z_prev, has_prev=jnp.array(True), prev_ok=jnp.array(True),
            pred_rob=C_ref._rob_pose(ocp_ref, p_ref.x0_rob),
            pred_hums=p_ref.hums0[:, :2])
        u = np.stack([rng.uniform(0.2, 0.8, 4), rng.uniform(-0.5, 0.5, 4)],
                     -1).astype(np.float32)
        for carry_ref in (fresh, prev):
            (z_sel_w, starts_w), brake_w, Xr_w, wall_w, m_w = ref(
                carry_ref, p_ref, u)
            carry = C.CAMPCCarry(*[t(x) for x in carry_ref])
            z_sel, starts = C._build_starts(ocp, carry, p)
            assert tuple(starts.shape) == (4, cfg_ref.n_z)
            close(z_sel, z_sel_w, 1e-5, "selected guess")
            for k, name in enumerate(("selected", "fresh", "brake",
                                      "side-step")):
                close(starts[k], starts_w[k], 1e-5, f"{name} start")
            shifted += int(not np.array_equal(np.asarray(z_sel_w),
                                              np.asarray(starts_w[1])))
            close(C._evasive_brake_action(ocp, p), brake_w, 1e-5, "brake")
            close(C._min_wall_clearance(p, t(Xr_w)), wall_w, 1e-5,
                  "wall clearance")
            close(C.exact_plan_margin(ocp, p, t(u), cfg_ref.brake_horizon),
                  m_w, 1e-5, "margin at brake_horizon")
    assert shifted == len(problems)   # the shifted guess differs from fresh


def test_cascade_options_run():
    """campc_action with every cascade option on, on the port alone (a
    reference run would compile the whole controller again; its parts are
    held to the reference in test_starts_and_brake): batched multi-start,
    the best-margin rescue, the evasive brake, wall-aware realism, the
    guess-margin horizon and adaptive effort run and give finite actions."""
    ocp = OCP.OCP(OCP.MPCConfig(**dict(PROTOCOL, **OPTIONS)), device="cpu")
    env = port_cfg(ENV)
    s_ref = _states((14,))[0]
    s = to_torch(s_ref)
    mid, lw = _mid(s_ref, 3)
    carry = C.init_carry(ocp)
    for _ in range(2):
        a, carry, aux = C.campc_action(ocp, s, carry, env,
                                       IPM.IPMSettings(n_iter=2),
                                       mid_samples=t(mid), mid_logw0=t(lw),
                                       aux=True)
        assert tuple(a.shape) == (2,) and bool(torch.isfinite(a).all())
        assert bool(carry.prev_ok) == (not bool(aux.use_guess))
        assert not (bool(aux.braked) and bool(aux.rescued))

"""The port's batched SICNav-Diffusion policy against its unbatched self.

The unbatched port is held to the JAX reference step by step
(tests/test_torch_jmid.py, test_torch_kde.py, test_torch_campc*.py); here
each episode of a batch must get what it gets alone:

- the batched forecaster (the B scenes through the encoder and every
  denoiser pass as one batch, one KDE call of B x horizon groups), with
  the same injected start noise: 1e-5 absolute, float32 rounding of
  batched against unbatched products on values of order 1; and with
  per-episode generators, the same noise drawn as each episode alone
  draws it;
- the KDE ranking of a batch, joint and iMID: the same top samples, their
  log-weights within 1e-5;
- the MPC half (``act_on_forecasts_batch``, ``torch.func.vmap`` over the
  episodes) in float64 at B = 2, the protocol's MPC sizes and
  IPMSettings(n_iter=3): the action within 1e-6 and every cascade flag
  equal. float32 would move an unconverged solve's action by up to 1e-2
  (PERF.md, "Review fixes"), so the comparison is made in float64.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion import kde as KDE
from sicnav_tpu_torch.diffusion.mid import JMIDModel
from sicnav_tpu_torch.diffusion.models import ModelConfig
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ipm
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
from sicnav_tpu_torch.mpc.ocp import OCP
from sicnav_tpu_torch.policies import dwa as D

from tests.test_torch_kde_kernel import _forecasts

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=2, n_heads=4)
PROTOCOL = EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                     human_num=3, max_humans=3, starts_moving=0,
                     time_limit=30, robot_kinematics="unicycle")
CASES = [0, 1, 5]
ACTION_TOL = 1e-6
CASCADE = ("use_guess", "sol_feasible", "sol_realistic", "cost_worse",
           "braked", "rescued")


def _lead(tree, i):
    return CS.tree_map(lambda x: x[i], tree)


def _f64(tree):
    return CS.tree_map(lambda x: x.double() if x.is_floating_point() else x,
                       tree)


def _history(cfg, fcfg, steps=3):
    """States and forecaster histories of CASES after ``steps`` DWA steps."""
    states = CS.reset_batch(cfg, CASES, device="cpu")
    fstate = CS.stack([FC.init_state(cfg.max_humans, fcfg, device="cpu")
                       for _ in CASES])
    for _ in range(steps):
        fstate = FC.update_state_hists(fstate, states, fcfg)
        states, _, _ = CS.step_masked(states, D.dwa_policy_batch(states, cfg),
                                      cfg)
    return states, FC.update_state_hists(fstate, states, fcfg)


@pytest.mark.parametrize("cfg", [PROTOCOL, EnvConfig()],
                         ids=["protocol", "defaults"])
def test_batched_forecast_equals_per_episode(cfg):
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               ddim_stride=20, dt=cfg.dt)
    torch.manual_seed(0)
    model = JMIDModel(ModelConfig(**SMALL), device="cpu")
    states, fstate = _history(cfg, fcfg)
    H, S, F = cfg.max_humans, fcfg.num_samples, fcfg.horizon
    x_T = torch.as_tensor(np.random.default_rng(1).normal(
        size=(len(CASES), S * H, F, 2)).astype(np.float32))
    batch = FC._scene_batch_from_hist(fstate, states, fcfg)
    samples = model.sample(batch, S, x_T=x_T, stride=fcfg.ddim_stride)
    fc, lw = FC.predict_ret_best(model, fstate, states, fcfg, x_T=x_T)
    assert fc.shape == (len(CASES), H, 10, F + 1, 2)
    for i in range(len(CASES)):
        b_i = FC._scene_batch_from_hist(_lead(fstate, i), _lead(states, i),
                                        fcfg)
        s_i = model.sample(b_i, S, x_T=x_T[i], stride=fcfg.ddim_stride)
        torch.testing.assert_close(samples[i], s_i, rtol=0, atol=1e-5)
        fc_i, lw_i = FC.predict_ret_best(model, _lead(fstate, i),
                                         _lead(states, i), fcfg, x_T=x_T[i])
        torch.testing.assert_close(fc[i], fc_i, rtol=0, atol=1e-5)
        torch.testing.assert_close(lw[i], lw_i, rtol=0, atol=1e-5)


def test_batched_forecast_draws_each_episodes_noise():
    """With one generator per episode, an episode's forecast in the batch
    is its forecast alone from the same generator state."""
    cfg = PROTOCOL
    fcfg = FC.ForecasterConfig(num_samples=16, num_ret_samples=4,
                               ddim_stride=50, dt=cfg.dt)
    torch.manual_seed(0)
    model = JMIDModel(ModelConfig(**SMALL), device="cpu")
    states, fstate = _history(cfg, fcfg)
    gens = [torch.Generator().manual_seed(s) for s in (3, 3, 4)]
    fc, lw = FC.predict_ret_best(model, fstate, states, fcfg, generator=gens)
    for i, seed in enumerate((3, 3, 4)):
        fc_i, lw_i = FC.predict_ret_best(
            model, _lead(fstate, i), _lead(states, i), fcfg,
            generator=torch.Generator().manual_seed(seed))
        torch.testing.assert_close(fc[i], fc_i, rtol=0, atol=1e-5)
        torch.testing.assert_close(lw[i], lw_i, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="one generator per episode"):
        FC.predict_ret_best(model, fstate, states, fcfg, generator=gens[:2])


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "imid"])
def test_batched_ranking_equals_per_episode(joint):
    fc = torch.stack([torch.as_tensor(_forecasts(s, joint, H=3))
                      for s in range(4)])
    top, lw = KDE.most_likely_samples(fc, 10, joint=joint)
    assert top.shape == (4, 3, 10, 8, 2) and lw.shape == (4, 3, 10)
    for i in range(4):
        top_i, lw_i = KDE.most_likely_samples(fc[i], 10, joint=joint)
        torch.testing.assert_close(top[i], top_i, rtol=0, atol=0)
        torch.testing.assert_close(lw[i], lw_i, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def protocol_step():
    """The batched protocol policy's inputs at control step 2 of CASES[:2]:
    states, MPC carries and served forecasts from the trained forecaster."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    model = chip_smoke.trained_model("cpu")
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               dt=PROTOCOL.dt)
    states, fstate = _history(PROTOCOL, fcfg, steps=2)
    gens = [torch.Generator().manual_seed(0) for _ in CASES]
    fc, lw = FC.predict_ret_best(model, fstate, states, fcfg, generator=gens)
    ocp = OCP(SD.make_policy(PROTOCOL, None, device="cpu")[0].cfg,
              device="cpu")
    carries = CS.stack([C.init_carry(ocp) for _ in CASES])
    return model, fcfg, _lead_n(states, 2), _lead_n(carries, 2), fc[:2], lw[:2]


def _lead_n(tree, n):
    return CS.tree_map(lambda x: x[:n], tree)


def _batched_vs_single(mpc_cfg, inputs, settings):
    _, _, states, carries, fc, lw = inputs
    st, ca, fc, lw = (_f64(x) for x in (states, carries, fc, lw))
    ocp_b = OCP(mpc_cfg, device="cpu", vmapped=True)
    a_b, carry_b, aux_b = SD.act_on_forecasts_batch(
        ocp_b, st, ca, fc, lw, PROTOCOL, settings, aux=True)
    assert a_b.dtype == torch.float64 and a_b.shape == (2, 2)
    ocp = OCP(mpc_cfg, device="cpu")
    for i in range(2):
        a_i, carry_i, aux_i = SD.act_on_forecasts(
            ocp, _lead(st, i), _lead(ca, i), fc[i], lw[i], PROTOCOL,
            settings, aux=True)
        torch.testing.assert_close(a_b[i], a_i, rtol=0, atol=ACTION_TOL)
        for name in CASCADE:
            assert bool(getattr(aux_b, name)[i] == getattr(aux_i, name)), name
        for name in ("door_stall", "door_latch", "prev_ok", "num_prev_used"):
            assert bool(getattr(carry_b, name)[i] == getattr(carry_i, name))
        torch.testing.assert_close(carry_b.z_prev[i], carry_i.z_prev,
                                   rtol=0, atol=1e-5)
    return a_b


def test_batched_mpc_step_equals_per_episode(protocol_step):
    """make_policy's fused configuration (RA-L robot, close-to-preds,
    door-yield, the brake gate on the adopted guess) at 3 IPM iterations."""
    mpc_cfg = SD.make_policy(PROTOCOL, None, device="cpu")[0].cfg
    assert mpc_cfg.brake_on_unreal_guess and mpc_cfg.door_yield
    a = _batched_vs_single(mpc_cfg, protocol_step, ipm.IPMSettings(n_iter=3))
    assert bool(torch.isfinite(a).all())


def test_batched_evasive_brake_equals_per_episode(protocol_step):
    """The evasive brake, a branch the unbatched step takes after a host
    read, computed and selected in the batch (one IPM iteration)."""
    mpc_cfg = dataclasses.replace(
        SD.make_policy(PROTOCOL, None, device="cpu")[0].cfg,
        evasive_brake=True)
    _batched_vs_single(mpc_cfg, protocol_step, ipm.IPMSettings(n_iter=1))


def test_batched_policy_refuses_what_it_cannot_batch(protocol_step):
    """An unbatched OCP is refused. adaptive_effort, once refused here,
    now batches: each episode's budget is a tensor
    (tests/test_torch_campc_plain_batch.py holds it to unbatched runs)."""
    model, fcfg, states, carries, fc, lw = protocol_step
    ocp_b, init_fn, step_fn = SD.make_policy(
        PROTOCOL, model, fcfg=fcfg, settings=ipm.IPMSettings(n_iter=1),
        mpc_overrides={"adaptive_effort": 2}, device="cpu", batch=True)
    failed = carries._replace(has_prev=torch.tensor([True, True]),
                              prev_ok=torch.tensor([False, True]))
    a, _ = SD.act_on_forecasts_batch(ocp_b, states, failed, fc, lw, PROTOCOL,
                                     ipm.IPMSettings(n_iter=1))
    assert a.shape == (2, 2) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="vmapped=True"):
        SD.act_on_forecasts_batch(OCP(ocp_b.cfg, device="cpu"), states,
                                  carries, fc, lw, PROTOCOL)


def test_batch_carries_and_seeds():
    ocp, init_fn, _ = SD.make_policy(PROTOCOL, None, device="cpu",
                                     batch=True)
    assert ocp.vmapped
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               dt=PROTOCOL.dt)
    carry = init_fn([4, 5, 6])
    assert carry.mpc.z_prev.shape == (3, ocp.cfg.n_z)
    assert carry.forecaster.hist.shape == (3, 3, fcfg.past_frames, 2)
    draws = [torch.randn(4, generator=g) for g in carry.generator]
    want = torch.randn(4, generator=torch.Generator().manual_seed(0))
    for d in draws:
        torch.testing.assert_close(d, want, rtol=0, atol=0)
    _, init_fn, _ = SD.make_policy(PROTOCOL, None, device="cpu", batch=True,
                                   seed_per_case=True)
    gens = init_fn([4, 5]).generator
    for g, seed in zip(gens, (4, 5)):
        torch.testing.assert_close(
            torch.randn(4, generator=g),
            torch.randn(4, generator=torch.Generator().manual_seed(seed)),
            rtol=0, atol=0)


def test_chip_smoke_batch_rehearsal():
    """chip_smoke.py's batch phase (the main path at B episodes and its
    float64 gate), run at B = 2 for two steps of 3 IPM iterations on the
    CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda

    ocp, _, settings, (final, carries), launches = chip_smoke.phase_batch(
        kde_cuda, device="cpu", n_episodes=2, steps=2, gate_cases=2,
        n_iter=3, measured={"b1_step_s": 1.0})
    assert launches == 0                   # CPU tensors take the plain version
    assert ocp.vmapped and settings.n_iter == 3
    assert final.r_pos.shape == (2, 2) and len(carries.generator) == 2

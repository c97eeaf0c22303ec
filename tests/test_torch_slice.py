"""The port's first slice end to end against the JAX reference: five steps of
the hallway-bottleneck loop on host case 0, composed identically on both
sides. Each step pushes the human positions into the forecaster, serves a
JMID forecast (small widths, 48 samples, DDIM stride 20, KDE top 10) and
steps the env with the DWA robot's action. Both sides get the same
parameters (converted) and the same DDIM start noise (the reference's).

Tolerances:
- human and robot states, 1e-5 absolute (as tests/test_torch_env.py);
- the 48 forecast samples, 1e-4 absolute (as tests/test_torch_jmid.py);
- the served forecasts: the same shape, finite, the current pose first,
  every served trajectory one of that side's own samples (or its
  constant-velocity forecast outside the cluster), and log-weights that
  normalize to 1e-4.

Which samples the joint KDE serves is not compared here. At the shipped
bandwidths (0.01 to 0.1) the reference's whitened coordinates reach
|x| sigma / bw^2, far above 1 for metre-scale positions, and the float32
rounding of its Gram-form distance grows with their square: on live
forecasts rounding, not the data, can pick the reference's top 10.
tests/test_torch_kde.py holds the ranking to the reference on inputs where
the data decide it.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import forecaster as FC_ref
from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.policies import dwa as D_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import types as T
from sicnav_tpu_torch.policies import dwa as D

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 5
SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=2, n_heads=4)


def _port_cfg(cfg_ref):
    fields = dataclasses.asdict(cfg_ref)
    fields["rewards"] = T.RewardConfig(**fields["rewards"])
    return T.EnvConfig(**fields)


def _state_close(got, want, tol):
    for name in ("r_pos", "r_vel", "r_theta", "h_pos", "h_vel", "t"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=tol, err_msg=name)
    assert bool(got.done) == bool(want.done)


def _ref_samples(model, params, fstate, sim, key, cfg):
    """The reference's predict_ret_best up to the ranking: (S, H, T, 2)."""
    batch = FC_ref._scene_batch_from_hist(fstate, sim, cfg)
    dist = jnp.linalg.norm(sim.h_pos - sim.r_pos[None], axis=-1)
    in_cluster = batch.agent_mask & (dist < cfg.cluster_radius)
    batch = batch._replace(agent_mask=in_cluster,
                           neighbor_mask=batch.neighbor_mask &
                           in_cluster[:, None] & in_cluster[None, :])
    samples = model.apply(params, batch, key, cfg.num_samples,
                          stride=cfg.ddim_stride, method=MID_ref.JMIDModel.sample)
    cv = FC_ref.cvmm_forecast(sim, cfg)
    return jnp.where(in_cluster[None, :, None, None], samples, cv[None])


def _port_samples(model, fstate, sim, cfg, x_T):
    batch = FC._scene_batch_from_hist(fstate, sim, cfg)
    dist = torch.linalg.norm(sim.h_pos - sim.r_pos[None], dim=-1)
    in_cluster = batch.agent_mask & (dist < cfg.cluster_radius)
    batch = batch._replace(agent_mask=in_cluster,
                           neighbor_mask=batch.neighbor_mask &
                           in_cluster[:, None] & in_cluster[None, :])
    samples = model.sample(batch, cfg.num_samples, x_T=x_T,
                           stride=cfg.ddim_stride)
    cv = FC.cvmm_forecast(sim, cfg)
    return torch.where(in_cluster[None, :, None, None], samples, cv[None])


# the shipped env defaults (3 humans in 8 slots, starting over 10 steps,
# 15 s) and the definitive protocol's (3 in 3, all at once, 30 s)
CONFIGS = {
    "defaults": T_ref.EnvConfig(),
    "protocol": T_ref.EnvConfig(scenario="hallway_bottleneck",
                                human_policy="orca_plus", human_num=3,
                                max_humans=3, starts_moving=0, time_limit=30,
                                robot_kinematics="unicycle"),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_slice_loop_matches_reference(config):
    cfg_ref = CONFIGS[config]
    cfg = _port_cfg(cfg_ref)
    fcfg_ref = FC_ref.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                       ddim_stride=20, dt=cfg_ref.dt)
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               ddim_stride=20, dt=cfg.dt)
    H, S, F, k = cfg.max_humans, 48, fcfg.horizon, 10

    s_ref = CS_ref.reset_host(cfg_ref, 0)
    s = CS.reset_host(cfg, 0, device="cpu")
    _state_close(s, s_ref, 1e-5)

    model_ref = MID_ref.JMIDModel(M_ref.ModelConfig(**SMALL), joint=True)
    f_ref = FC_ref.init_state(H, fcfg_ref)
    key = jax.random.PRNGKey(0)
    params = model_ref.init({"params": key, "dropout": key},
                            FC_ref._scene_batch_from_hist(f_ref, s_ref, fcfg_ref),
                            key)
    model = MID.JMIDModel(M.ModelConfig(**SMALL), device="cpu")
    model.load_state_dict(convert.jmid_state_dict(
        jax.tree.map(np.asarray, params)))
    f = FC.init_state(H, fcfg, device="cpu")

    predict_ref = jax.jit(FC_ref.predict_ret_best, static_argnames=("model", "cfg"))
    samples_ref_fn = jax.jit(_ref_samples, static_argnames=("model", "cfg"))
    dwa_ref = jax.jit(D_ref.dwa_policy, static_argnames="env_cfg")
    step_ref = jax.jit(CS_ref.step_masked, static_argnames="cfg")
    for _ in range(STEPS):
        key, k_fc = jax.random.split(key)
        x_T = torch.as_tensor(np.asarray(jax.random.normal(
            jax.random.split(k_fc)[0], (S * H, F, 2))))

        f_ref = FC_ref.update_state_hists(f_ref, s_ref, fcfg_ref)
        fc_ref, lw_ref = predict_ref(model_ref, params, f_ref, s_ref, k_fc,
                                     fcfg_ref)
        smp_ref = np.asarray(samples_ref_fn(model_ref, params, f_ref, s_ref,
                                            k_fc, fcfg_ref))
        f = FC.update_state_hists(f, s, fcfg)
        np.testing.assert_allclose(f.hist.numpy(), np.asarray(f_ref.hist),
                                   atol=1e-5)
        fc, lw = FC.predict_ret_best(model, f, s, fcfg, x_T=x_T)
        smp = _port_samples(model, f, s, fcfg, x_T).numpy()

        np.testing.assert_allclose(smp, smp_ref, rtol=0, atol=1e-4)
        for served, weights, own, sim in [(fc.numpy(), lw.numpy(), smp, s),
                                          (np.asarray(fc_ref),
                                           np.asarray(lw_ref), smp_ref, s_ref)]:
            assert served.shape == (H, k, F + 1, 2) and weights.shape == (H, k)
            assert np.isfinite(served).all() and np.isfinite(weights).all()
            np.testing.assert_allclose(served[:, :, 0],
                                       np.broadcast_to(np.asarray(sim.h_pos)[:, None],
                                                       (H, k, 2)), atol=1e-6)
            for h in range(H):
                for j in range(k):
                    assert np.any(np.all(own[:, h] == served[h, j, 1:],
                                         axis=(-1, -2)))
            lse = np.log(np.exp(weights.astype(np.float64)).sum(-1))
            np.testing.assert_allclose(lse, 0.0, atol=1e-4)

        a_ref = dwa_ref(s_ref, cfg_ref)
        a = D.dwa_policy(s, cfg)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-5)
        s_ref, _, _ = step_ref(s_ref, a_ref, cfg_ref)
        s, _, _ = CS.step_masked(s, a, cfg)
        _state_close(s, s_ref, 1e-5)


def test_chip_smoke_main_path_rehearsal():
    """chip_smoke.py's main path and cross-check, run small on the CPU: the
    script only runs on a card, so this is where its control flow is
    exercised before a chip run."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda

    model, launches = chip_smoke.phase_slice(
        kde_cuda, device="cpu", mcfg=M.ModelConfig(**SMALL), max_steps=3)
    assert launches == 0                   # CPU tensors take the plain version
    chip_smoke.phase_cross(model, device="cpu")


def test_chip_smoke_mpc_rehearsal():
    """chip_smoke.py's main path (the protocol's MPC loop with the trained
    weights) and its MPC cross-check, run for two steps on the CPU."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda

    ocp, model, settings, record, launches = chip_smoke.phase_mpc(
        kde_cuda, device="cpu", max_steps=2)
    assert launches == 0                   # CPU tensors take the plain version
    assert settings.n_iter == 30 and ocp.cfg.robot_nx == 8
    chip_smoke.phase_cross_mpc(ocp, record, settings, device="cpu")

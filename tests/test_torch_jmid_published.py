"""JMID at its published size, and the benchmark's circle-crossing
configuration, on the CPU.

- ``weights/jmid_mc_man_nod.npz`` (``ddim_jp_sim.yaml``'s widths: context
  256, three transformer layers, one node type, joint), read with numpy
  alone, against the JAX package's JMID on the Orbax checkpoint it was
  converted from: the encoder's output and a DDIM sample from the same
  start noise, on two scenes of 5 humans. Tolerance 1e-4 absolute, as
  ``tests/test_torch_jmid.py`` holds samples: float32 matrix products,
  LSTM gates, softmax and LayerNorm reduce in other orders in XLA and
  PyTorch, a few 1e-6 on values of order 1 after one pass and up to a few
  1e-5 after the sampler's 50 passes and the integration of the
  velocities.
- ``forecaster.predict_ret_best`` in float32 against the benchmark's frozen
  reference (``portbench/reference/frozen``) in float64, from the same
  start noise, on seeded random weights at a small width with three
  layers: 5 humans, 12 samples, top 4.
- The configuration ``sicnav_diffusion_circle5_jmid256`` builds the OCP
  sizes it states through ``make_policy(batch=True)``.
- The DDIM loop's counters ``denoise_passes`` and ``denoise_rows``, and
  samples bit for bit alike with the tracer on and off.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench.lib import port as PB
from portbench.reference.frozen.diffusion import forecaster as FC_frozen
from portbench.reference.frozen.diffusion import mid as MID_frozen
from portbench.reference.frozen.diffusion import models as M_frozen
from sicnav_tpu.diffusion import data as DATA_ref
from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import data as DATA
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.env import crowd_sim
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
from sicnav_tpu_torch.utils import tracing

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "jmid_mc_man_nod")
WEIGHTS = os.path.join(ROOT, "weights", "jmid_mc_man_nod.npz")
CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "sicnav_diffusion_circle5_jmid256.json")
WIDTHS = dict(context_dim=256, tf_layer=3, num_node_types=1)
SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=3, n_heads=4)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _scene(seed, A=5, T_h=6, T_f=8):
    """Five humans walking, one of them with a short history."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.2, (A, T_h, 2)), axis=1) + \
        rng.uniform(-3, 3, (A, 1, 2))
    vel = np.concatenate([np.zeros((A, 1, 2)), np.diff(pos, axis=1) / 0.25], 1)
    acc = np.concatenate([np.zeros((A, 1, 2)), np.diff(vel, axis=1) / 0.25], 1)
    hist_mask = np.ones((A, T_h), bool)
    hist_mask[1, :2] = False
    hist = np.where(hist_mask[..., None],
                    np.concatenate([pos, vel, acc], -1), 0.0)
    d = np.linalg.norm(pos[:, None, -1] - pos[None, :, -1], axis=-1)
    neighbor_mask = (d < 3.0) & ~np.eye(A, dtype=bool)
    return DATA_ref.SceneBatch(
        hist=hist.astype(np.float32), hist_mask=hist_mask,
        fut_vel=np.zeros((A, T_f, 2), np.float32),
        fut_mask=np.zeros((A, T_f), bool), agent_mask=np.ones(A, bool),
        neighbor_mask=neighbor_mask)


def _stack(scenes):
    """The port's SceneBatch of scenes on a leading axis."""
    return DATA.SceneBatch(*[None if xs[0] is None else
                             torch.as_tensor(np.stack(xs))
                             for xs in zip(*scenes)])


def test_jmid_mc_man_nod_against_reference():
    """The converted file in the port against the JAX package's JMID on the
    Orbax checkpoint: encoder output and DDIM samples (4 samples, stride 2,
    50 passes) of two 5-human scenes, each from the reference's own start
    noise."""
    scenes = [_scene(11), _scene(12)]
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**WIDTHS), joint=True)
    key = jax.random.PRNGKey(0)
    # the checkpoint's template from shapes alone: an eager init at this
    # width takes ~18 s here
    like = jax.eval_shape(ref.init, {"params": key, "dropout": key},
                          jax.tree.map(jnp.asarray, scenes[0]), key)
    on_cpu = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        x.shape, x.dtype, sharding=on_cpu), like)
    params = MID_ref.load_checkpoint(os.path.abspath(CKPT), like)
    model = MID.JMIDModel(M.ModelConfig(**WIDTHS), joint=True, device="cpu")
    model.load_state_dict(convert.load_npz(WEIGHTS), strict=True)
    assert model.denoiser_joint

    n, A, T = 4, 5, 8
    sample = jax.jit(lambda p, b, k: ref.apply(
        p, b, k, n, stride=2, method=MID_ref.JMIDModel.sample))
    ctx_want, want, x_T = [], [], []
    for i, s in enumerate(scenes):
        jb = jax.tree.map(jnp.asarray, s)
        k = jax.random.PRNGKey(100 + i)
        ctx_want.append(np.asarray(ref.apply(
            params, jb, method=MID_ref.JMIDModel.encode)))
        want.append(np.asarray(sample(params, jb, k)))
        # the reference draws x_T from the first half of split(key)
        x_T.append(np.asarray(jax.random.normal(jax.random.split(k)[0],
                                                (n * A, T, 2))))
    batch = _stack(scenes)
    ctx = model.encode(batch)
    np.testing.assert_allclose(ctx.numpy(), np.stack(ctx_want), rtol=0,
                               atol=TOL)
    got = model.sample(batch, n, x_T=torch.as_tensor(np.stack(x_T)),
                       stride=2)
    assert tuple(got.shape) == (2, n, A, T, 2)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=TOL)


def _random_weights(seed):
    torch.manual_seed(seed)
    model = MID.JMIDModel(M.ModelConfig(**SMALL), joint=True, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    return model


def _walked(B=2, steps=4):
    """B circle-crossing episodes of 5 ORCA humans after ``steps`` env steps
    with the robot still, and the forecaster's history of them."""
    cfg = EnvConfig(scenario="circle_crossing", human_policy="orca",
                    human_num=5, max_humans=5, starts_moving=0)
    fcfg = FC.ForecasterConfig(num_samples=12, num_ret_samples=4,
                               dt=cfg.dt)
    states = crowd_sim.reset_batch(cfg, list(range(3, 3 + B)), device="cpu")
    fstate = FC.init_state(cfg.max_humans, fcfg, device="cpu")
    fstate = FC.ForecasterState(*[x.expand(B, *x.shape).clone()
                                  for x in fstate])
    for _ in range(steps):
        fstate = FC.update_state_hists(fstate, states, fcfg)
        states, _, _ = crowd_sim.step_masked(
            states, torch.zeros((B, 2)), cfg)
    return FC.update_state_hists(fstate, states, fcfg), states, fcfg


def _generators(B, seed=7):
    return [torch.Generator().manual_seed(seed + b) for b in range(B)]


def test_predict_ret_best_against_frozen_reference():
    """The port's forecaster in float32 against the frozen reference in
    float64 from the same start noise: the served forecasts and the
    log-weights of the top 4 of 12 samples. The start noise is drawn at a
    scale of 0.02 so that the samples lie within the KDE's bandwidths
    (0.01-0.1 m) of each other and the ranking is decided by the pair
    terms, not by ties of lone self terms. Samples drift by float32
    rounding (~1e-6 a pass) and the log-likelihoods by the KDE's sums of
    12 exponentials, so 1e-4 on both; the ranking is the same."""
    model = _random_weights(3)
    frozen = MID_frozen.JMIDModel(M_frozen.ModelConfig(**SMALL), joint=True,
                                  device="cpu")
    frozen.load_state_dict(model.state_dict())
    frozen = frozen.to(torch.float64)
    fstate, states, fcfg = _walked()
    B = states.h_pos.shape[0]
    x_T = 0.02 * torch.randn((B, 12 * 5, 8, 2),
                             generator=torch.Generator().manual_seed(1))
    fc, lw = FC.predict_ret_best(model, fstate, states, fcfg, x_T=x_T)
    fcfg_ref = FC_frozen.ForecasterConfig(**{
        f: getattr(fcfg, f) for f in fcfg.__dataclass_fields__})
    fc_ref, lw_ref = FC_frozen.predict_ret_best(
        frozen, PB.to_double(fstate), PB.to_double(states), fcfg_ref,
        x_T=x_T.double())
    assert tuple(fc.shape) == (B, 5, 4, 9, 2)
    assert fc.dtype == torch.float32 and fc_ref.dtype == torch.float64
    # the ranking separates the samples: no tie among the served ones
    assert (lw_ref[:, 0].diff(dim=-1) > 1e-3).all()
    np.testing.assert_allclose(fc.double().numpy(), fc_ref.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lw.double().numpy(), lw_ref.numpy(), rtol=0,
                               atol=TOL)


def test_circle5_configuration_builds_its_sizes():
    """make_policy(batch=True) with the configuration's options builds the
    n_z and KKT size the file states (what the benchmark's drivers check
    and its operation counts take)."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    env_cfg = EnvConfig(**cfg["env"])
    fcfg = FC.ForecasterConfig(dt=env_cfg.dt, **cfg["forecaster"])
    ocp, _, _ = SD.make_policy(env_cfg, None, fcfg=fcfg, device="cpu",
                               batch=True, **PB.policy_kwargs(cfg))
    assert (ocp.cfg.n_z, ocp.cfg.n_z + ocp.n_eq) == (261, 481)
    PB.check_ocp(cfg, ocp)
    assert cfg["model"]["widths"] == {"context_dim": 256, "tf_layer": 3}
    assert (fcfg.num_samples, fcfg.num_ret_samples, fcfg.ddim_stride) == \
        (100, 10, 2)
    assert cfg["reduced"] == []


@pytest.mark.parametrize("stride", [2, 5])
def test_denoise_counters(stride):
    """``denoise_passes`` is 100 / stride and ``denoise_rows`` episodes x
    samples x agents x horizon, both in ``forecast.denoise``; with the
    tracer off nothing is recorded, and the samples are the same bit for
    bit either way."""
    model = _random_weights(5)
    fstate, states, fcfg = _walked(B=3, steps=1)
    batch = FC._scene_batch_from_hist(fstate, states, fcfg)
    B, A, n = 3, 5, 12

    tracing.enable("cpu")
    on = model.sample(batch, n, generator=_generators(B), stride=stride)
    tracing.disable()
    snap = tracing.snapshot()
    assert snap.total("denoise_passes", under="forecast.denoise") == \
        100 // stride
    assert snap.total("denoise_rows", under="forecast.denoise") == \
        B * n * A * model.cfg.horizon
    assert snap.total("denoise_passes") == 100 // stride

    tracing.reset()
    off = model.sample(batch, n, generator=_generators(B), stride=stride)
    assert tracing.snapshot().counts == []
    assert torch.equal(on, off)

"""Parity of the port's JMID predictor (sicnav_tpu_torch.diffusion and
sicnav_tpu_torch.convert) with the JAX reference.

The reference's Flax parameters go through ``convert.jmid_state_dict`` into
the port; then ``encode``, ``denoise`` and DDIM ``sample`` (with the
reference's start noise injected) must agree. The scene has absent agents,
so the denoiser sees fully masked attention rows. Tolerance 1e-4 absolute:
float32 matmuls, LSTM gates, softmax and LayerNorm reduce in different
orders in XLA and PyTorch, which leaves differences of a few 1e-6 on values
of order 1 after one network pass and up to a few 1e-5 after a sampler's
chain of passes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import data as DATA_ref
from sicnav_tpu.diffusion import diffusion as DF_ref
from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import data as DATA
from sicnav_tpu_torch.diffusion import diffusion as DF
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M

torch.set_num_threads(2)
TOL = 1e-4
SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=2, n_heads=4)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "jmid_hallway")
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "jmid_hallway.npz")


def _scene(seed, A=5, T_h=6, T_f=8, absent=(2, 4)):
    """A scene with absent agents and one with a short history."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.2, (A, T_h, 2)), axis=1) + \
        rng.uniform(-2, 2, (A, 1, 2))
    vel = np.concatenate([np.zeros((A, 1, 2)), np.diff(pos, axis=1) / 0.25], 1)
    acc = np.concatenate([np.zeros((A, 1, 2)), np.diff(vel, axis=1) / 0.25], 1)
    hist_mask = np.ones((A, T_h), bool)
    hist_mask[1, :3] = False
    agent_mask = ~np.isin(np.arange(A), absent)
    hist_mask &= agent_mask[:, None]
    hist = np.where(hist_mask[..., None],
                    np.concatenate([pos, vel, acc], -1), 0.0)
    d = np.linalg.norm(pos[:, None, -1] - pos[None, :, -1], axis=-1)
    neighbor_mask = (d < 3.0) & agent_mask[:, None] & agent_mask[None, :] & \
        ~np.eye(A, dtype=bool)
    return DATA_ref.SceneBatch(
        hist=hist.astype(np.float32), hist_mask=hist_mask,
        fut_vel=np.zeros((A, T_f, 2), np.float32),
        fut_mask=np.zeros((A, T_f), bool), agent_mask=agent_mask,
        neighbor_mask=neighbor_mask)


def _to_torch(batch):
    return DATA.SceneBatch(*[None if x is None else torch.as_tensor(np.array(x))
                             for x in batch])


def _init(ref, batch):
    key = jax.random.PRNGKey(0)
    return jax.jit(ref.init)({"params": key, "dropout": key},
                             jax.tree.map(jnp.asarray, batch), key)


@functools.lru_cache(maxsize=None)
def _small_params():
    """Reference parameters at the small widths; they depend on the scene's
    shapes only, which all small-width tests share."""
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**SMALL), joint=True)
    return _init(ref, _scene(0))


def _models(cfg_kw, batch, params=None):
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    if params is None:
        params = _small_params()
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), joint=True, device="cpu")
    port.load_state_dict(convert.jmid_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return ref, params, port


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def test_config_defaults_match():
    import dataclasses
    assert dataclasses.asdict(M.ModelConfig()) == \
        dataclasses.asdict(M_ref.ModelConfig())


def test_helpers():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(DATA.derivative_of(torch.as_tensor(x), 0.25).numpy(),
                               DATA_ref.derivative_of(x, 0.25), atol=1e-6)
    np.testing.assert_array_equal(M.positional_encoding(8, 64).numpy(),
                                  np.asarray(M_ref.positional_encoding(8, 64)))
    hist = rng.normal(size=(4, 6, 6)).astype(np.float32)
    cur = rng.normal(size=(4, 2)).astype(np.float32)
    _close(M.standardize_history(torch.as_tensor(hist), torch.as_tensor(cur)),
           M_ref.standardize_history(hist, cur), 1e-6)
    vel = rng.normal(size=(5, 4, 8, 2)).astype(np.float32)
    _close(M.integrate_velocity_samples(torch.as_tensor(vel),
                                        torch.as_tensor(cur[None]), 0.25),
           M_ref.integrate_velocity_samples(vel, cur[None], 0.25), 1e-6)


def test_schedule():
    want = DF_ref.make_schedule(100)
    got = DF.make_schedule(100, device="cpu")
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_encode(seed):
    batch = _scene(seed)
    ref, params, port = _models(SMALL, batch)
    want = ref.apply(params, jax.tree.map(jnp.asarray, batch),
                     method=MID_ref.JMIDModel.encode)
    _close(port.encode(_to_torch(batch)), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_denoise_with_absent_agents(seed):
    batch = _scene(seed)
    ref, params, port = _models(SMALL, batch)
    rng = np.random.default_rng(seed + 10)
    A, T = batch.hist.shape[0], 8
    x = rng.normal(size=(A, T, 2)).astype(np.float32)
    beta = np.full((A,), 0.02, np.float32)
    ctx = rng.normal(size=(A, 2 * SMALL["enc_rnn_dim"])).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    want = ref.apply(params, x, beta, ctx, jb,
                     method=MID_ref.JMIDModel.denoise)
    got = port.denoise(torch.as_tensor(x)[None], torch.as_tensor(beta)[None],
                       torch.as_tensor(ctx)[None], _to_torch(batch))[0]
    assert torch.isfinite(got).all()
    _close(got, want)


def test_sample_with_injected_noise():
    batch = _scene(2)
    ref, params, port = _models(SMALL, batch)
    n, stride = 6, 10
    A, T = batch.hist.shape[0], 8
    key = jax.random.PRNGKey(3)
    want = ref.apply(params, jax.tree.map(jnp.asarray, batch), key, n,
                     stride=stride, method=MID_ref.JMIDModel.sample)
    # the reference draws x_T from the first half of split(key)
    x_T = jax.random.normal(jax.random.split(key)[0], (n * A, T, 2))
    got = port.sample(_to_torch(batch), n, x_T=torch.as_tensor(np.asarray(x_T)),
                      stride=stride)
    assert tuple(got.shape) == (n, A, T, 2)
    _close(got, want)


def test_hallway_checkpoint_full_width():
    """The shipped hallway predictor at full width (context_dim 128, two
    transformer layers), loaded with the reference's own reader."""
    cfg_kw = dict(context_dim=128, tf_layer=2)
    batch = _scene(4, A=8, absent=(2, 4, 6, 7))
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    jb = jax.tree.map(jnp.asarray, batch)
    params = MID_ref.load_checkpoint(os.path.abspath(CKPT), _init(ref, batch))
    ref, params, port = _models(cfg_kw, batch, params)
    # the weights the card runs: the converted file committed with the port,
    # read with numpy alone, is the same predictor
    from_file = MID.JMIDModel(M.ModelConfig(**cfg_kw), joint=True,
                              device="cpu")
    from_file.load_state_dict(convert.load_npz(WEIGHTS), strict=True)

    ctx_ref = ref.apply(params, jb, method=MID_ref.JMIDModel.encode)
    ctx = port.encode(_to_torch(batch))
    _close(ctx, ctx_ref)
    _close(from_file.encode(_to_torch(batch)), ctx_ref)

    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 8, 2)).astype(np.float32)
    beta = np.full((8,), float(np.asarray(DF_ref.make_schedule(100).betas[50])),
                   np.float32)
    want = ref.apply(params, x, beta, ctx_ref, jb,
                     method=MID_ref.JMIDModel.denoise)
    got = port.denoise(torch.as_tensor(x)[None], torch.as_tensor(beta)[None],
                       ctx[None], _to_torch(batch))[0]
    _close(got, want)
    got = from_file.denoise(torch.as_tensor(x)[None],
                            torch.as_tensor(beta)[None], ctx[None],
                            _to_torch(batch))[0]
    _close(got, want)


def test_converted_weights_regenerate():
    """scripts/convert_jmid_torch.py, run on the repo's checkpoint, gives
    the committed file's arrays exactly."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import convert_jmid_torch
    fresh = convert_jmid_torch.convert(os.path.abspath(CKPT))
    with np.load(WEIGHTS) as f:
        assert sorted(f.files) == sorted(fresh)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], fresh[k], err_msg=k)

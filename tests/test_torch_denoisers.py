"""Parity of the port's denoiser family, class-conditioned encoder and
diffusion schedules / samplers (``sicnav_tpu_torch.diffusion.models``,
``diffusion.diffusion``, ``mid``) with the JAX reference.

Each of the nine ``DIFFNETS`` is built at small widths by the reference,
its Flax parameters go through ``convert.jmid_state_dict`` (and back
through ``convert.flax_params``, which must give the same tree), and then:
``denoise`` within 1e-4 (float32 matmuls, softmax and LayerNorm reduce in
other orders in XLA and PyTorch: a few 1e-6 on values of order 1), and the
training loss with the reference's t and eps injected within 1e-5 (dropout
0, as the reference's loss is compared deterministically).

The class-conditioned encoder (``num_node_types = 3``) is held to 1e-4 at
small widths and with ``checkpoints/jmid_mc`` at full width, converted
inside the test. The schedules must equal the reference's float32 arrays
to 2 ulp; DDIM and DDPM, with and without ``bestof`` and at two
``flexibility`` values, with the reference's draws rebuilt from its key
and injected, within 1e-4 of the samples' largest magnitude (at least 1:
DDIM on the cosine schedule carries samples of order 1e3).
"""

import dataclasses
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
LOSS_TOL = 1e-5
SMALL = dict(context_dim=16, enc_rnn_dim=8, tf_layer=2, n_heads=2,
             dropout=0.0, rnn_dropout=0.0)
ROOT = os.path.join(os.path.dirname(__file__), "..")
MC_CKPT = os.path.join(ROOT, "checkpoints", "jmid_mc")


def scene(seed, A=5, T_h=6, T_f=8, absent=(3,), types=None):
    """A scene with an absent agent, a short history and observed futures
    (one agent's cut short)."""
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
    fut_mask = np.ones((A, T_f), bool) & agent_mask[:, None]
    fut_mask[0, 5:] = False
    fut_vel = np.where(fut_mask[..., None],
                       rng.normal(0, 0.8, (A, T_f, 2)), 0.0)
    return DATA_ref.SceneBatch(
        hist=hist.astype(np.float32), hist_mask=hist_mask,
        fut_vel=fut_vel.astype(np.float32), fut_mask=fut_mask,
        agent_mask=agent_mask, neighbor_mask=neighbor_mask,
        node_type=None if types is None else np.asarray(types, np.int32))


def to_torch(batch):
    return DATA.SceneBatch(*[None if x is None else torch.as_tensor(
        np.array(x)) for x in batch])


def build(cfg_kw, joint, batch, seed=0):
    """(reference model, its params, the port's model with them)."""
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=joint)
    key = jax.random.PRNGKey(seed)
    params = jax.jit(ref.init)({"params": key, "dropout": key},
                               jax.tree.map(jnp.asarray, batch), key)
    params = jax.tree.map(np.asarray, params)
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), joint=joint, device="cpu")
    port.load_state_dict(convert.jmid_state_dict(params), strict=True)
    return ref, params, port


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=0, atol=tol)


def same_tree(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("name", sorted(M.DIFFNETS))
def test_denoiser_matches_flax(name):
    ctor, joint = M.DIFFNETS[name]
    cfg_kw = dict(SMALL, diffnet=name,
                  residual=name == "TrajNet")
    batch = scene(len(name))
    ref, params, port = build(cfg_kw, True, batch)
    assert port.denoiser_joint == joint
    # the inverse map gives the reference's own tree
    n_heads = cfg_kw["n_heads"]
    same_tree(convert.flax_params(port.state_dict(), n_heads), params)

    rng = np.random.default_rng(7)
    A, T = batch.hist.shape[0], 8
    x = rng.normal(size=(A, T, 2)).astype(np.float32)
    beta = np.full((A,), 0.03, np.float32)
    ctx = rng.normal(size=(A, 2 * SMALL["enc_rnn_dim"])).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, batch)
    want = ref.apply(params, x, beta, ctx, jb,
                     method=MID_ref.JMIDModel.denoise)
    xt, bt, ct = (torch.as_tensor(v) for v in (x, beta, ctx))
    if joint:                    # the port's joint nets take a sample axis
        got = port.denoise(xt[None], bt[None], ct[None], to_torch(batch))[0]
    else:
        got = port.denoise(xt, bt, ct, to_torch(batch))
    assert torch.isfinite(got).all()
    close(got, want)

    # the training loss with the reference's t and eps injected
    key = jax.random.PRNGKey(11)
    want = ref.apply(params, jb, key, rngs={"dropout": key})
    k_t, k_e = jax.random.split(key)
    t = jax.random.randint(k_t, (A,), 1, 101)
    eps = jax.random.normal(k_e, (A, T, 2))
    port.train()
    got = port(to_torch(batch), t=torch.as_tensor(np.asarray(t)).long(),
               eps=torch.as_tensor(np.asarray(eps)))
    port.eval()
    close(got, want, LOSS_TOL)


def test_linear_decoder_matches_flax():
    ref = M_ref.LinearDecoder(out_dim=12)
    code = np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), code))
    port = M.LinearDecoder(out_dim=12, in_dim=32)
    sd = {}
    for name, p in params["params"].items():
        pre = "out" if name == "out" else f"layers.{name.split('_')[1]}"
        sd[pre + ".weight"] = torch.as_tensor(p["kernel"].T)
        sd[pre + ".bias"] = torch.as_tensor(p["bias"])
    port.load_state_dict(sd, strict=True)
    close(port(torch.as_tensor(code)), ref.apply(params, code), 1e-5)


def test_positional_encoding_any_length():
    """One set of weights serves every horizon: the encoding of a position
    does not depend on the sequence's length."""
    pos = M._PositionalTokens(8, 32)
    for T in (5, 8, 12):
        np.testing.assert_array_equal(
            pos(T).numpy(), np.asarray(M_ref.positional_encoding(T, 32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_class_conditioned_encoder(seed):
    cfg_kw = dict(SMALL, num_node_types=3)
    batch = scene(seed, types=[0, 1, 2, 0, 1])
    ref, params, port = build(cfg_kw, True, batch, seed)
    assert "encoder.class_film.weight" in port.state_dict()
    same_tree(convert.flax_params(port.state_dict(), SMALL["n_heads"]),
              params)
    jb = jax.tree.map(jnp.asarray, batch)
    want = ref.apply(params, jb, method=MID_ref.JMIDModel.encode)
    close(port.encode(to_torch(batch)), want)
    # no node types: all class 0, as the reference
    plain = batch._replace(node_type=None)
    want0 = ref.apply(params, jax.tree.map(jnp.asarray, plain),
                      method=MID_ref.JMIDModel.encode)
    close(port.encode(to_torch(plain)), want0)
    assert np.abs(np.asarray(want) - np.asarray(want0)).max() > 1e-3
    # the class-conditioned loss with injected t and eps
    key = jax.random.PRNGKey(5)
    want = ref.apply(params, jb, key, rngs={"dropout": key})
    k_t, k_e = jax.random.split(key)
    t = jax.random.randint(k_t, (5,), 1, 101)
    eps = jax.random.normal(k_e, (5, 8, 2))
    port.train()
    got = port(to_torch(batch), t=torch.as_tensor(np.asarray(t)).long(),
               eps=torch.as_tensor(np.asarray(eps)))
    close(got, want, LOSS_TOL)


def test_jmid_mc_full_width():
    """The shipped class-conditioned JMID checkpoint (context 128, two
    layers, three node types), converted here from Orbax: encoder and
    denoiser against the reference."""
    cfg_kw = dict(context_dim=128, tf_layer=2, num_node_types=3)
    batch = scene(4, A=6, absent=(4,), types=[0, 1, 2, 1, 0, 2])
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    key = jax.random.PRNGKey(0)
    jb = jax.tree.map(jnp.asarray, batch)
    like = ref.init({"params": key, "dropout": key}, jb, key)
    params = jax.tree.map(np.asarray, MID_ref.load_checkpoint(
        os.path.abspath(MC_CKPT), like))
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    port.load_state_dict(convert.jmid_state_dict(params), strict=True)
    ctx_ref = ref.apply(params, jb, method=MID_ref.JMIDModel.encode)
    ctx = port.encode(to_torch(batch))
    close(ctx, ctx_ref)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 8, 2)).astype(np.float32)
    beta = np.full((6,), 0.02, np.float32)
    want = ref.apply(params, x, beta, ctx_ref, jb,
                     method=MID_ref.JMIDModel.denoise)
    got = port.denoise(torch.as_tensor(x)[None], torch.as_tensor(beta)[None],
                       ctx[None], to_torch(batch))[0]
    close(got, want)


def ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got.view(np.int32).astype(np.int64) -
                  want.view(np.int32).astype(np.int64)).max()


@pytest.mark.parametrize("mode,kw", [
    ("linear", {}), ("cosine", {}),
    ("linear", dict(num_steps=50, beta_1=1e-3, beta_T=2e-2)),
    ("cosine", dict(num_steps=40, cosine_s=1e-2))])
def test_schedules(mode, kw):
    want = DF_ref.make_schedule(mode=mode, **kw)
    got = DF.make_schedule(mode=mode, device="cpu", **kw)
    assert got.num_steps == want.num_steps
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == torch.float32
        assert ulps(g.numpy(), w) <= 2
    with pytest.raises(ValueError):
        DF.make_schedule(mode="quadratic", device="cpu")


def toy_net(seed, F=6):
    """A small deterministic eps-network of (x, beta, ctx) in both
    frameworks, with the same weights."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, (2 + 1 + F, 2)).astype(np.float32)

    def ref(x, beta, ctx):
        h = jnp.concatenate([x, jnp.broadcast_to(beta[:, None, None],
                                                 x.shape[:2] + (1,)),
                             jnp.broadcast_to(ctx[:, None, :],
                                              x.shape[:2] + (F,))], -1)
        return jnp.tanh(h @ w)

    wt = torch.as_tensor(w)

    def port(x, beta, ctx):
        h = torch.cat([x, beta[..., None, None].expand(*x.shape[:-1], 1),
                       ctx[..., None, :].expand(*x.shape[:-1], F)], -1)
        return torch.tanh(h @ wt)

    return ref, port


@pytest.mark.parametrize("sampling,flexibility,bestof,mode", [
    ("ddim", 0.0, True, "linear"), ("ddim", 0.0, False, "linear"),
    ("ddpm", 0.0, True, "linear"), ("ddpm", 0.5, False, "cosine"),
    ("ddpm", 1.0, True, "cosine"), ("ddim", 0.5, True, "cosine")])
def test_sampler_with_injected_draws(sampling, flexibility, bestof, mode):
    """The reference's start noise and per-step draws, rebuilt from its key
    as ``diffusion.sample`` splits it, injected into the port."""
    n, B, T, stride = 3, 4, 8, 5
    sched_ref = DF_ref.make_schedule(100, mode)
    sched = DF.make_schedule(100, mode, device="cpu")
    ctx = np.random.default_rng(1).normal(size=(B, 6)).astype(np.float32)
    ref_net, port_net = toy_net(3)
    key = jax.random.PRNGKey(21)
    want = DF_ref.sample(ref_net, sched_ref, key, n, jnp.asarray(ctx), T,
                         sampling=sampling, stride=stride,
                         flexibility=flexibility, bestof=bestof)
    k_init, k_loop = jax.random.split(key)
    ts = np.arange(100, 0, -stride)
    x_T = jax.random.normal(k_init, (n * B, T, 2)) if bestof else None
    noise = np.stack([np.asarray(jax.random.normal(k, (n * B, T, 2)))
                      for k in jax.random.split(k_loop, len(ts))])
    got = DF.sample(port_net, sched, n, torch.as_tensor(ctx), T,
                    sampling=sampling, stride=stride, flexibility=flexibility,
                    bestof=bestof,
                    x_T=None if x_T is None else torch.as_tensor(
                        np.asarray(x_T)),
                    noise=torch.as_tensor(noise))
    assert tuple(got.shape) == (n, B, T, 2)
    # DDIM on the cosine schedule divides by sqrt(alpha_bar_100) ~ 1e-3
    # and carries samples of order 1e3, where a float32 ulp is 1e-4: the
    # bound scales with the samples' size
    close(got, want, TOL * max(1.0, float(np.abs(np.asarray(want)).max())))
    if sampling == "ddpm":
        # the draws matter: other noise gives other samples
        other = DF.sample(port_net, sched, n, torch.as_tensor(ctx), T,
                          sampling=sampling, stride=stride,
                          flexibility=max(flexibility, 0.5), bestof=bestof,
                          generator=torch.Generator().manual_seed(0))
        assert (other - got).abs().max() > 1e-3


def test_sampler_rejects_start_noise_without_bestof():
    sched = DF.make_schedule(10, device="cpu")
    _, net = toy_net(0)
    with pytest.raises(ValueError, match="bestof"):
        DF.sample(net, sched, 2, torch.zeros(3, 6), 8, bestof=False,
                  x_T=torch.zeros(6, 8, 2))
    with pytest.raises(ValueError):
        DF.sample(net, sched, 2, torch.zeros(3, 6), 8, sampling="euler")


def test_config_fields_match():
    assert [f.name for f in dataclasses.fields(M.ModelConfig)] == \
        [f.name for f in dataclasses.fields(M_ref.ModelConfig)]
    assert sorted(M.DIFFNETS) == sorted(M_ref.DIFFNETS)
    for name, (_, joint) in M_ref.DIFFNETS.items():
        assert M.DIFFNETS[name][1] == joint

"""Parity of the port's Trajectron++ CVAE machinery
(``sicnav_tpu_torch.diffusion.trajectron``) with the JAX reference.

The functions (GMM2D, the discrete latent, the N-pair loss, unicycle
dynamics) within 1e-5 on the same inputs, with the reference's draws
rebuilt from its key and injected where it draws; the GMM2D density also
against scipy, as ``tests/test_trajectron.py`` checks the reference. The
map encoder and ``CVAETrajectron`` (``train_loss``, ``predict``) with the
reference's parameters converted (``convert.map_encoder_state_dict``,
``convert.cvae_state_dict``): 1e-5 for the loss, 1e-4 for positions after
a GRU rollout and an integration (float32 matmuls in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu.diffusion import trajectron as TJ_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.diffusion import trajectron as TJ
from tests.test_torch_denoisers import scene, to_torch

torch.set_num_threads(2)
TOL = 1e-5


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=0, atol=tol)


def gmm_inputs(seed, lead=(3, 4), N=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=lead + (N,)).astype(f),
            rng.normal(size=lead + (N, 2)).astype(f),
            rng.normal(scale=0.3, size=lead + (N, 2)).astype(f),
            rng.uniform(-0.8, 0.8, size=lead + (N,)).astype(f))


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm2d(seed):
    args = gmm_inputs(seed)
    g_ref = TJ_ref.make_gmm2d(*map(jnp.asarray, args))
    g = TJ.make_gmm2d(*map(t, args))
    for a, b in zip(g, g_ref):
        close(a, b)
    x = np.random.default_rng(seed + 5).normal(size=(3, 4, 2)).astype(
        np.float32)
    close(TJ.gmm2d_log_prob(g, t(x)), TJ_ref.gmm2d_log_prob(g_ref, x))
    close(TJ.gmm2d_mode(g), TJ_ref.gmm2d_mode(g_ref))
    # rsample from the reference's draws
    key = jax.random.PRNGKey(seed)
    want = TJ_ref.gmm2d_rsample(g_ref, key)
    k_n, k_c = jax.random.split(key)
    z = jax.random.normal(k_n, g_ref.mus.shape)
    comp = jax.random.categorical(k_c, g_ref.log_pis)
    close(TJ.gmm2d_rsample(g, z=t(z), comp=t(comp)), want)
    # flattened mus / log_sigmas
    flat = TJ.make_gmm2d(t(args[0]), t(args[1]).reshape(3, 4, 6),
                         t(args[2]).reshape(3, 4, 6), t(args[3]))
    close(flat.mus, g.mus, 0)


def test_gmm2d_log_prob_scipy():
    from scipy.stats import multivariate_normal
    log_pis, mus, log_sigmas, corrs = gmm_inputs(2, lead=())
    g = TJ.make_gmm2d(t(log_pis), t(mus), t(log_sigmas), t(corrs))
    x = np.random.default_rng(0).normal(size=(2,))
    pis = np.exp(log_pis - np.logaddexp.reduce(log_pis))
    pdf = 0.0
    for i in range(3):
        s = np.exp(log_sigmas[i].astype(np.float64))
        cov = np.array([[s[0] ** 2, corrs[i] * s[0] * s[1]],
                        [corrs[i] * s[0] * s[1], s[1] ** 2]])
        pdf += pis[i] * multivariate_normal.pdf(x, mus[i], cov)
    np.testing.assert_allclose(
        float(TJ.gmm2d_log_prob(g, t(x.astype(np.float32)))), np.log(pdf),
        rtol=1e-5)


def test_gmm2d_from_cov():
    rng = np.random.default_rng(1)
    mus = rng.normal(size=(4, 1, 2)).astype(np.float32)
    A_ = rng.normal(size=(4, 1, 2, 2))
    covs = (A_ @ np.swapaxes(A_, -1, -2) + 0.1 * np.eye(2)).astype(np.float32)
    g_ref = TJ_ref.gmm2d_from_cov(jnp.zeros((4, 1)), mus, covs)
    g = TJ.gmm2d_from_cov(torch.zeros(4, 1), t(mus), t(covs))
    for a, b in zip(g, g_ref):
        close(a, b)
    close(TJ.gmm2d_mode(g), mus[:, 0], 1e-6)


def test_discrete_latent():
    rng = np.random.default_rng(2)
    h = rng.normal(size=(5, 2 * 3)).astype(np.float32) * 3
    for clip in (None, 2.0):
        close(TJ.latent_logits(t(h), 2, 3, clip),
              TJ_ref.latent_logits(jnp.asarray(h), 2, 3, clip))
    q = TJ_ref.latent_logits(jnp.asarray(h), 2, 3, 2.0)
    p = TJ_ref.latent_logits(jnp.asarray(h[::-1].copy()), 2, 3)
    for kl_min in (0.0, 0.07, 10.0):
        close(TJ.kl_q_p(t(q), t(p), kl_min), TJ_ref.kl_q_p(q, p, kl_min))
    close(TJ.mutual_inf(t(p)), TJ_ref.mutual_inf(p))
    np.testing.assert_array_equal(TJ.all_one_hot_combinations(2, 3),
                                  TJ_ref.all_one_hot_combinations(2, 3))
    key = jax.random.PRNGKey(4)
    for mode in ("full", "most_likely"):
        z, n = TJ.sample_p(t(p), 3, mode)
        z_ref, n_ref = TJ_ref.sample_p(p, key, 3, mode)
        assert n == n_ref
        close(z, z_ref, 0)
    z_ref, _ = TJ_ref.sample_p(p, key, 3, "sample")
    draws = np.stack([np.asarray(jax.random.categorical(k, p))
                      for k in jax.random.split(key, 3)])
    z, n = TJ.sample_p(t(p), 3, "sample", draws=t(draws))
    assert n == 1
    close(z, z_ref, 0)


def test_npair_loss():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 8)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    for target in ([0, 0, 1, 1, 2, 2], [0, 1, 2, 3, 4, 5], [0, 0, 0, 1, 1, 0]):
        target = np.array(target)
        close(TJ.npair_loss(t(x), t(target), t(valid)),
              TJ_ref.npair_loss(jnp.asarray(x), jnp.asarray(target),
                                jnp.asarray(valid)))


def test_unicycle():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 4)).astype(np.float32)
    u = rng.normal(scale=0.5, size=(7, 2)).astype(np.float32)
    u[:2, 0] = [0.0, 0.005]                     # the straight branch
    close(TJ.unicycle_dynamic(t(x), t(u), 0.25),
          TJ_ref.unicycle_dynamic(x, u, 0.25))
    # the turning step divides sin / cos differences by dphi and dphi^2,
    # so float32 rounding grows as 1 / dphi^2 near the straight branch's
    # threshold; the rollout is held where |dphi| >= 0.2
    controls = rng.normal(scale=0.3, size=(3, 6, 2)).astype(np.float32)
    controls[..., 0] = np.sign(controls[..., 0]) * (
        0.2 + np.abs(controls[..., 0]))
    p0 = rng.normal(size=(3, 2)).astype(np.float32)
    v0 = rng.normal(size=(3, 2)).astype(np.float32)
    close(TJ.unicycle_integrate(t(controls), t(p0), t(v0), 0.25, 0.1),
          TJ_ref.unicycle_integrate(controls, p0, v0, 0.25, 0.1))


def test_cnn_map_encoder():
    x = np.random.default_rng(6).normal(size=(2, 40, 40, 3)).astype(
        np.float32)
    ref = TJ_ref.CNNMapEncoder(output_size=8)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), x))
    port = TJ.CNNMapEncoder(3, 40, output_size=8)
    port.load_state_dict(convert.map_encoder_state_dict(params), strict=True)
    close(port(t(x)), ref.apply(params, x))


CFG = dict(context_dim=16, enc_rnn_dim=8, tf_layer=1, history_len=6,
           horizon=8)


def cvae_pair():
    cfg_kw = dict(CFG, rnn_dropout=0.0)
    batch = scene(7, A=4, absent=(2,))
    ref = TJ_ref.CVAETrajectron(M_ref.ModelConfig(**cfg_kw), latent_k=5,
                                dec_rnn_dim=16)
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, ref.init(
        {"params": key, "dropout": key}, jax.tree.map(jnp.asarray, batch),
        key))
    port = TJ.CVAETrajectron(M.ModelConfig(**cfg_kw), latent_k=5,
                             dec_rnn_dim=16, device="cpu")
    port.load_state_dict(convert.cvae_state_dict(params), strict=True)
    return ref, params, port, batch


def test_cvae_train_loss_and_predict():
    ref, params, port, batch = cvae_pair()
    jb = jax.tree.map(jnp.asarray, batch)
    tb = to_torch(batch)
    key = jax.random.PRNGKey(1)
    close(port.train_loss(tb), ref.apply(params, jb, key))
    # the mode of the most likely latent, and every latent class
    for args in ((3,), (2, "full", True)):
        want, n_ref = ref.apply(params, jb, key, *args,
                                method=TJ_ref.CVAETrajectron.predict)
        got, n = port.predict(tb, *args)
        assert n == n_ref
        close(got, want, 1e-4)
    # sampled latents and GMM2D draws: the reference draws both from one
    # key, the latents from split(key, S) and the GMM from split(key)
    S = 4
    want, _ = ref.apply(params, jb, key, S, "sample", False,
                        method=TJ_ref.CVAETrajectron.predict)
    x = ref.apply(params, jb, method=TJ_ref.CVAETrajectron.encode_x)
    p_logits = TJ_ref.latent_logits(
        ref.apply(params, x, method=lambda m, x: m.p_head(x)), 1, 5)
    z_draws = np.stack([np.asarray(jax.random.categorical(k, p_logits))
                        for k in jax.random.split(key, S)])
    k_n, k_c = jax.random.split(key)
    A, T = batch.hist.shape[0], CFG["horizon"]
    y_noise = jax.random.normal(k_n, (S, A, T, 1, 2))
    y_comp = jax.random.categorical(k_c, jnp.zeros((S, A, T, 1)))
    got, _ = port.predict(tb, S, "sample", False, z_draws=t(z_draws),
                          y_noise=t(y_noise), y_comp=t(y_comp))
    close(got, want, 1e-4)


def test_cvae_trains():
    """Adam on the port's CVAE lowers its loss, from Flax's
    initializers."""
    cfg = M.ModelConfig(**CFG)
    port = TJ.CVAETrajectron(cfg, latent_k=5, dec_rnn_dim=16, device="cpu")
    M.init_parameters(port, torch.Generator().manual_seed(0))
    cell = port.decoder_rnn_cell.hr.weight
    eye = cell @ cell.T
    close(eye, torch.eye(16), 1e-5)             # orthogonal recurrent kernel
    batches = [to_torch(scene(s, A=3, absent=())) for s in range(3)]
    opt = torch.optim.Adam(port.parameters(), lr=3e-3)
    losses = []
    for i in range(30):
        opt.zero_grad()
        loss = port.train_loss(batches[i % 3])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

"""Parity of the port's KDE ranking (sicnav_tpu_torch.ops.kde_cuda,
sicnav_tpu_torch.diffusion.kde) with the JAX reference.

(a) The plain version of the kernel's function against the Pallas kernel
    run in interpret mode, as tests/test_kde_pallas.py runs it.
(b) ``kde_loglik_fused`` (whitening + pairwise part) against the reference.
(c) ``most_likely_samples``, joint and iMID.

(a) and (b) use the kernel's own tolerance, rtol = atol = 2e-4. (c) returns
samples, so the selection must be equal: the inputs (see ``_forecasts``) put
the k-th and (k+1)-th likelihoods further apart than the tolerance, and the
test asserts it. Samples inside the top k may be near-equal, so selections
are compared sample by sample, and each selected sample's log-weight is
held to 2e-4.

The CUDA kernel itself runs only on a card: the tests marked ``gpu`` hold it
against the plain version there and skip elsewhere.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import kde as KDE_ref
from sicnav_tpu.ops import kde_pallas as K_ref
from sicnav_tpu_torch.diffusion import kde as KDE
from sicnav_tpu_torch.ops import kde_cuda as K

torch.set_num_threads(2)
TOL = 2e-4
SHAPES = [(1, 7, 2), (3, 20, 24), (5, 33, 12), (8, 48, 16)]
MAIN_PATH_SHAPES = [(8, 48, 16), (64, 48, 2)]


def _inputs(G, S, D):
    """Samples at a spread of 2/sqrt(D) per coordinate, so pair distances
    are of order 1 at every D and the terms j != i carry weight in every
    row's sum (at a spread of order 1 and D = 16 they would all be below
    1e-22, and a kernel that dropped them would still agree)."""
    rng = np.random.default_rng(G * 100 + S)
    y = (rng.normal(size=(G, S, D)) * 2 / np.sqrt(D)).astype(np.float32)
    z = rng.uniform(1, 5, (G,)).astype(np.float32)
    return y, z


def _assert_pairs_weigh(z, out):
    """Most rows get more than 10 % of their sum from the pairs j != i (the
    self term is exp(-log_Z), so the pairs' share is 1 - exp(-log_Z - out))."""
    share = 1 - np.exp(-np.asarray(z)[:, None] - np.asarray(out))
    assert (share > 0.1).mean() >= 0.75, share


@pytest.mark.parametrize("G,S,D", SHAPES)
def test_plain_matches_pallas_kernel(G, S, D):
    y, z = _inputs(G, S, D)
    want = K_ref._kde_loglik_pallas_impl(jnp.asarray(y), jnp.asarray(z),
                                         interpret=True)
    _assert_pairs_weigh(z, want)
    got = K.kde_loglik_plain(torch.as_tensor(y), torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    y, z = _inputs(3, 20, 24)
    before = K.kde_loglik.launches
    got = K.kde_loglik(torch.as_tensor(y), torch.as_tensor(z))
    want = K.kde_loglik_plain(torch.as_tensor(y), torch.as_tensor(z))
    assert torch.equal(got, want)
    assert K.kde_loglik.launches == before


def test_wrapper_refuses_other_devices():
    y = torch.empty((2, 5, 3), device="meta")
    z = torch.empty((2,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.kde_loglik(y, z)


@pytest.mark.parametrize("G,S,D,per_group", [(4, 24, 16, True),
                                             (8, 48, 16, True),
                                             (16, 48, 2, False)])
def test_kde_loglik_fused(G, S, D, per_group):
    rng = np.random.default_rng(G + D)
    preds = rng.normal(size=(G, S, D)).astype(np.float32)
    bw = (rng.uniform(0.3, 1.2, (G,)).astype(np.float32) if per_group
          else 0.5)
    want = K_ref.kde_loglik_fused(jnp.asarray(preds), bw)
    got = K.kde_loglik_fused(torch.as_tensor(preds),
                             torch.as_tensor(bw) if per_group else bw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _forecasts(seed, joint, S=48, H=4, T=8, sizes=(6, 4, 3, 2, 2), n_out=10,
               R=10.0):
    """Forecasts whose ranking the data decide, not rounding.

    The reference whitens without centring and takes distances in Gram form,
    so its rounding grows with |y|^2, and where samples lie far apart in
    whitened units every likelihood is the self term and they tie. Here ten
    far samples (at +-R) set the covariance, which keeps the others' whitened
    coordinates small; their rows only shift all likelihoods of a group
    alike, which the top-k weights cancel. The other samples sit in tight
    clusters of the given sizes, laid out in the whitened unit of each
    step's bandwidth (bw^2 / sigma), so a sample's likelihood is set by its
    cluster's size and the top 10 (clusters of 6 and 4) stand apart from
    the 11th."""
    rng = np.random.default_rng(seed)
    cloud = S - n_out
    sigma = R * np.sqrt(n_out / (S - 1))
    bw = (np.exp(np.linspace(np.log(0.01), np.log(0.1), T)) if joint
          else np.full(T, 0.05))
    unit = (bw ** 2 / sigma)[None, None, :, None]
    n_centres = cloud - sum(sizes) + len(sizes)
    centres = rng.normal(0.0, 1.5, (n_centres, H, T, 2)) * unit
    label = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)] +
                           [np.arange(len(sizes), n_centres)])
    x = centres[rng.permutation(label)] + \
        rng.normal(0.0, 0.2, (cloud, H, T, 2)) * unit
    far = R * rng.choice([-1.0, 1.0], (n_out, H, T, 2))
    return np.concatenate([x, far])[rng.permutation(S)].astype(np.float32)


def _ref_lik(fc, joint):
    """The reference's per-sample summed log-likelihood (kde.py's ranking)."""
    S, H, T, _ = fc.shape
    fc = jnp.asarray(fc)
    if joint:
        preds = jnp.transpose(fc, (2, 0, 1, 3)).reshape(T, S, H * 2)
        bw = jnp.exp(jnp.linspace(np.log(0.01), np.log(0.1), T))
        ll = K_ref.kde_loglik_fused(preds, bw)
        ll = ll - jax.scipy.special.logsumexp(ll, axis=1, keepdims=True)
        return np.asarray(ll.sum(0))[None]
    preds = jnp.transpose(fc, (1, 2, 0, 3)).reshape(H * T, S, 2)
    ll = K_ref.kde_loglik_fused(preds, 0.05)
    ll = ll - jax.scipy.special.logsumexp(ll, axis=1, keepdims=True)
    return np.asarray(ll.reshape(H, T, S).sum(1))


def _by_sample(top, lw):
    """Top-k samples and weights put in a fixed order (by the samples' first
    coordinate), so selections can be compared whatever the order among
    near-equal likelihoods."""
    top, lw = np.asarray(top), np.asarray(lw)
    perm = np.argsort(top[:, :, 0, 0], axis=-1)
    return (np.take_along_axis(top, perm[:, :, None, None], axis=1),
            np.take_along_axis(lw, perm, axis=1))


@pytest.mark.parametrize("joint,seed", [(True, 0), (True, 1), (False, 0),
                                        (False, 3)])
def test_most_likely_samples(joint, seed):
    k = 10
    fc = _forecasts(seed, joint)
    lik = np.sort(_ref_lik(fc, joint), axis=-1)[:, -(k + 1):]
    assert np.isfinite(lik).all()
    gap = lik[:, 1] - lik[:, 0]
    assert gap.min() > TOL * max(1.0, np.abs(lik).max()), gap.min()

    top_ref, lw_ref = KDE_ref.most_likely_samples(jnp.asarray(fc), k,
                                                  joint=joint)
    top, lw = KDE.most_likely_samples(torch.as_tensor(fc), k, joint=joint)
    assert tuple(top.shape) == (4, k, 8, 2) and tuple(lw.shape) == (4, k)
    top_ref, lw_ref = _by_sample(top_ref, lw_ref)
    top, lw = _by_sample(top.numpy(), lw.numpy())
    np.testing.assert_array_equal(top, top_ref)
    np.testing.assert_allclose(lw, lw_ref, rtol=TOL, atol=TOL)


def test_find_nvcc_names_the_paths_it_tried(monkeypatch, tmp_path):
    from sicnav_tpu_torch.ops import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
        return
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        build.find_nvcc()
    assert str(tmp_path / "bin" / "nvcc") in str(err.value)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("G,S,D", SHAPES + MAIN_PATH_SHAPES[1:])
def test_cuda_kernel_matches_plain(G, S, D):
    _cuda_or_skip()
    y, z = _inputs(G, S, D)
    y, z = torch.as_tensor(y).cuda(), torch.as_tensor(z).cuda()
    before = K.kde_loglik.launches
    got = K.kde_loglik(y, z)
    torch.cuda.synchronize()
    assert K.kde_loglik.launches == before + 1
    want = K.kde_loglik_plain(y, z)
    _assert_pairs_weigh(z.cpu(), want.cpu())
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_cuda_most_likely_samples_matches_cpu():
    _cuda_or_skip()
    fc = torch.as_tensor(_forecasts(0, True))
    top_cpu, lw_cpu = KDE.most_likely_samples(fc, 10)
    top, lw = KDE.most_likely_samples(fc.cuda(), 10)
    torch.testing.assert_close(top.cpu(), top_cpu, rtol=0, atol=0)
    torch.testing.assert_close(lw.cpu(), lw_cpu, rtol=TOL, atol=TOL)

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

The CUDA kernel itself runs only on a card: its tests, marked ``gpu``, are
in ``tests/test_torch_kde_kernel.py``, which imports no JAX so that it runs
on the card's machine.
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
from tests.test_torch_kde_kernel import (SHAPES, TOL, _assert_pairs_weigh,
                                         _forecasts, _inputs)

torch.set_num_threads(2)


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

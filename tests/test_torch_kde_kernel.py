"""The port's CUDA KDE kernel (sicnav_tpu_torch/csrc/kde.cu, wrapper
``sicnav_tpu_torch.ops.kde_cuda.kde_loglik``) against its plain version.

This file imports no JAX, so that it runs on a machine with a card and
without JAX. ``tests/conftest.py`` imports JAX, so there it runs as

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kde_kernel.py

Tests marked ``gpu`` skip without a card. The tolerance is the kernel's,
rtol = atol = 2e-4. The inputs helpers here also serve
``tests/test_torch_kde.py``, which holds the plain version against JAX.
"""

import math

import numpy as np
import pytest
import torch

from sicnav_tpu_torch.diffusion import kde as KDE
from sicnav_tpu_torch.ops import kde_cuda as K

TOL = 2e-4
SHAPES = [(1, 7, 2), (3, 20, 24), (5, 33, 12), (8, 48, 16)]
MAIN_PATH_SHAPES = [(8, 48, 16), (64, 48, 2)]
# S > 64 and not a multiple of 32, odd D; S > 128 at an instantiated D; a
# wide D in the masked instantiation; shared memory above the default 48 KB,
# which the kernel takes only after opting in
KERNEL_SHAPES = [(2, 100, 3), (4, 130, 16), (2, 70, 40), (1, 800, 16)]


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


@pytest.mark.parametrize("S,D,ok", [(48, 16, True), (48, 64, True),
                                    (48, 65, False), (58111, 1, True),
                                    (58112, 1, False), (3631, 16, True),
                                    (3632, 16, False)])
def test_kernel_shape_limits(S, D, ok):
    """D up to 64 and shared memory up to 227 KB (D * (S | 1) floats)."""
    if ok:
        K.check_kernel_shape(S, D)
        return
    with pytest.raises(ValueError, match="D <= 64|shared memory"):
        K.check_kernel_shape(S, D)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("G,S,D", SHAPES + MAIN_PATH_SHAPES[1:] +
                         KERNEL_SHAPES)
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
def test_cuda_kernel_far_from_origin():
    """At the main path's shape with |y|^2 near 1.2e9, as the path's
    uncentred whitened samples have it: the float32 Gram form is no
    reference there, so the kernel is held to the plain version in float64."""
    _cuda_or_skip()
    G, S, D = MAIN_PATH_SHAPES[0]
    y, z = _inputs(G, S, D)
    y = torch.as_tensor(y + np.float32(math.sqrt(1.2e9 / D))).cuda()
    z = torch.as_tensor(z).cuda()
    got = K.kde_loglik(y, z).double()
    want = K.kde_loglik_plain(y.double(), z.double())
    _assert_pairs_weigh(z.cpu(), want.cpu())
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_cuda_wrapper_raises_for_wide_groups():
    _cuda_or_skip()
    y, z = torch.zeros((2, 5, 65), device="cuda"), torch.zeros(2, device="cuda")
    before = K.kde_loglik.launches
    with pytest.raises(ValueError, match="D <= 64"):
        K.kde_loglik(y, z)
    assert K.kde_loglik.launches == before


@pytest.mark.gpu
def test_cuda_most_likely_samples_matches_cpu():
    _cuda_or_skip()
    fc = torch.as_tensor(_forecasts(0, True))
    top_cpu, lw_cpu = KDE.most_likely_samples(fc, 10)
    top, lw = KDE.most_likely_samples(fc.cuda(), 10)
    torch.testing.assert_close(top.cpu(), top_cpu, rtol=0, atol=0)
    torch.testing.assert_close(lw.cpu(), lw_cpu, rtol=TOL, atol=TOL)

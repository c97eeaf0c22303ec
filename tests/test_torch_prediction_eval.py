"""Parity of the port's prediction evaluation (``diffusion/evaluation.py``,
``diffusion/baselines.py``, ``mid.eval_scene`` and ``mid.eval_scene_full``)
with the JAX reference.

Tolerances: the metrics 1e-6 (the same float32 reductions on values of
order 1); KDE-NLL 1e-4 (a 2 x 2 inverse and a log-determinant per step,
then a logsumexp), with NaN exactly where the reference gives NaN (a
singular covariance); the baselines 1e-6. ``eval_scene`` and
``eval_scene_full`` sample 50 DDIM passes from the start noise JAX draws
from ``split(key)[0]``: 1e-4, as ``tests/test_torch_jmid.py`` holds
samples. The most-likely metrics pick one sample by the KDE ranking, so
their inputs are built, and checked, so that the data decide the pick.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import baselines as BL_ref
from sicnav_tpu.diffusion import evaluation as EV_ref
from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu.env import walls as W_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.ops import kde_pallas as K_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import baselines as BL
from sicnav_tpu_torch.diffusion import data as D
from sicnav_tpu_torch.diffusion import evaluation as EV
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.ops import kde_cuda as K
from tests.test_torch_kde import TOL as KDE_TOL
from tests.test_torch_kde_kernel import _forecasts
from tests.test_torch_train import sim_examples

torch.set_num_threads(2)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "jmid_hallway")
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "jmid_hallway.npz")


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def agent_inputs(seed, S=20, T=8):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 0.3, (T, 2)), 0).astype(np.float32)
    pred = (gt[None] + np.cumsum(rng.normal(0, 0.2, (S, T, 2)), 1)
            ).astype(np.float32)
    mask = np.ones(T, bool)
    mask[rng.integers(2, T):] = False
    return pred, gt, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agent_metrics(seed):
    pred, gt, mask = agent_inputs(seed)
    for m in (None, mask, np.zeros_like(mask)):
        mt = None if m is None else t(m)
        close(EV.ade(t(pred), t(gt), mt), EV_ref.ade(pred, gt, m))
        close(EV.fde(t(pred), t(gt), mt), EV_ref.fde(pred, gt, m))
        for g, w in zip(EV.min_ade_fde(t(pred), t(gt), mt),
                        EV_ref.min_ade_fde(pred, gt, m)):
            close(g, w)
        for g, w in zip(EV.horizon_fraction_ade(t(pred), t(gt), mt),
                        EV_ref.horizon_fraction_ade(pred, gt, m)):
            close(g, w)


def test_agent_metrics_batched():
    """Leading axes score each agent as the reference's vmap does."""
    pa = [agent_inputs(s) for s in range(6)]
    pred = np.stack([p for p, _, _ in pa]).reshape(2, 3, 20, 8, 2)
    gt = np.stack([g for _, g, _ in pa]).reshape(2, 3, 8, 2)
    mask = np.stack([m for _, _, m in pa]).reshape(2, 3, 8)
    got = EV.min_ade_fde(t(pred), t(gt), t(mask))
    for i in range(2):
        for j in range(3):
            want = EV_ref.min_ade_fde(pred[i, j], gt[i, j], mask[i, j])
            close(got[0][i, j], want[0])
            close(got[1][i, j], want[1])


def test_kde_nll_with_singular_steps():
    cases = []
    for seed in range(4):
        pred, gt, _ = agent_inputs(seed)
        cases.append((pred, gt))
    pred, gt = cases[0]
    same = pred.copy()
    same[:, 3] = same[0, 3]            # every sample equal at one step
    line = pred.copy()
    line[:, 5, 1] = 2.0 * line[:, 5, 0]  # collinear samples at one step
    cases += [(same, gt), (line, gt)]
    nan = 0
    for pred, gt in cases:
        want = float(EV_ref.kde_nll(pred, gt))
        got = float(EV.kde_nll(t(pred), t(gt)))
        assert np.isnan(got) == np.isnan(want), (got, want)
        nan += np.isnan(want)
        if not np.isnan(want):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert nan >= 1
    # batched: one NaN agent leaves the others finite
    preds = np.stack([c[0] for c in cases])
    gts = np.stack([c[1] for c in cases])
    got = EV.kde_nll(t(preds), t(gts)).numpy()
    want = np.array([float(EV_ref.kde_nll(p, g)) for p, g in cases])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    close(got[~np.isnan(want)], want[~np.isnan(want)], 1e-4)


def scene_inputs(seed, S=20, A=5, T=8):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 0.3, (A, T, 2)), 1).astype(np.float32)
    pred = (gt[None] + np.cumsum(rng.normal(0, 0.2, (S, A, T, 2)), 2)
            ).astype(np.float32)
    amask = np.array([True, True, False, True, True])
    smask = np.ones((A, T), bool)
    smask[1, 4:] = False
    smask[3, 1:] = False
    return pred, gt, amask, smask


@pytest.mark.parametrize("seed", [0, 1])
def test_scene_ade_fde(seed):
    pred, gt, amask, smask = scene_inputs(seed)
    for sm in (None, smask):
        got = EV.scene_ade_fde(t(pred), t(gt), t(amask),
                               None if sm is None else t(sm))
        want = EV_ref.scene_ade_fde(pred, gt, amask, sm)
        close(got[0], want[0])
        close(got[1], want[1])
    # a leading scene axis
    p2, g2, a2, s2 = scene_inputs(seed + 10)
    got = EV.scene_ade_fde(t(np.stack([pred, p2])), t(np.stack([gt, g2])),
                           t(np.stack([amask, a2])), t(np.stack([smask, s2])))
    close(got[0][1], EV_ref.scene_ade_fde(p2, g2, a2, s2)[0])


def test_obstacle_violations():
    cfg = T_ref.EnvConfig(scenario="hallway_bottleneck")
    walls, wmask, _ = W_ref.build_walls(cfg)
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1.5, 1.5, (3, 20, 8, 2)).astype(np.float32)
    got = EV.obstacle_violations(t(pred), t(walls), t(wmask), 0.3)
    for a in range(3):
        want = EV_ref.obstacle_violations(pred[a], walls, wmask, 0.3)
        close(got[a], want)
    assert 0 < float(got.min()) < 1


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_most_likely_ade_fde(seed):
    """Clustered samples (tests/test_torch_kde_kernel.py's) whose most
    likely sample stands apart from the second by more than the kernel's
    tolerance in the reference's ranking."""
    fc = _forecasts(seed, True, S=48, H=4, sizes=(4, 3, 2))
    S, H, T, _ = fc.shape
    preds = jnp.transpose(jnp.asarray(fc), (2, 0, 1, 3)).reshape(T, S, H * 2)
    bw = jnp.exp(jnp.linspace(np.log(0.01), np.log(0.1), T))
    ll = K_ref.kde_loglik_fused(preds, bw)
    lik = np.sort(np.asarray((ll - jax.scipy.special.logsumexp(
        ll, axis=1, keepdims=True)).sum(0)))
    assert np.isfinite(lik).all()
    assert lik[-1] - lik[-2] > KDE_TOL * max(1.0, np.abs(lik[-2:]).max())
    rng = np.random.default_rng(seed)
    gt = fc.mean(0) + rng.normal(0, 0.1, (H, T, 2)).astype(np.float32)
    smask = np.ones((H, T), bool)
    smask[2, 5:] = False
    for sm in (None, smask):
        got = EV.most_likely_ade_fde(t(fc), t(gt), step_mask=None if sm is None
                                     else t(sm))
        want = EV_ref.most_likely_ade_fde(jnp.asarray(fc), jnp.asarray(gt),
                                          step_mask=sm)
        close(got[0], want[0])
        close(got[1], want[1])


@pytest.mark.parametrize("seed", [4, 6, 9])
def test_most_likely_ade_fde_per_agent(seed):
    """The iMID ranking (joint=False) at its ETH shape: 16 agents x 8 steps
    = 128 groups of 20 samples in 2 dimensions, the shape at which the
    reference runs its Pallas kernel. Clustered samples whose every agent's
    most likely sample stands apart from its second by more than the
    kernel's tolerance in the reference's ranking (checked)."""
    fc = _forecasts(seed, False, S=20, H=16, sizes=(4, 2))
    S, H, T, _ = fc.shape
    preds = jnp.transpose(jnp.asarray(fc), (1, 2, 0, 3)).reshape(H * T, S, 2)
    assert preds.shape == (128, 20, 2)
    ll = K_ref.kde_loglik_fused(preds, 0.05)
    lik = np.sort(np.asarray((ll - jax.scipy.special.logsumexp(
        ll, axis=1, keepdims=True)).reshape(H, T, S).sum(1)), -1)
    assert np.isfinite(lik).all()
    gap = lik[:, -1] - lik[:, -2]
    assert (gap > KDE_TOL * np.maximum(1.0, np.abs(lik[:, -2:]).max(-1))
            ).all()
    rng = np.random.default_rng(seed)
    gt = fc.mean(0) + rng.normal(0, 0.1, (H, T, 2)).astype(np.float32)
    amask = np.ones(H, bool)
    amask[[3, 11]] = False
    smask = np.ones((H, T), bool)
    smask[2, 5:] = False
    for sm in (None, smask):
        got = EV.most_likely_ade_fde(
            t(fc), t(gt), agent_mask=t(amask),
            step_mask=None if sm is None else t(sm), joint=False)
        want = EV_ref.most_likely_ade_fde(
            jnp.asarray(fc), jnp.asarray(gt), agent_mask=amask,
            step_mask=sm, joint=False)
        close(got[0], want[0])
        close(got[1], want[1])


def test_baselines():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    vel = rng.normal(0, 1, (6, 2)).astype(np.float32)
    radius = np.full(6, 0.3, np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1], bool)
    close(BL.standing_forecast(t(pos), 8), BL_ref.standing_forecast(pos, 8))
    close(BL.constant_velocity_forecast(t(pos), t(vel), 0.25, 8),
          BL_ref.constant_velocity_forecast(pos, vel, 0.25, 8))
    got = BL.cv_collision_fixed_forecast(t(pos), t(vel), t(radius), t(mask),
                                         0.25, 8)
    want = BL_ref.cv_collision_fixed_forecast(pos, vel, radius, mask, 0.25, 8)
    close(got, want)
    # the fix moved someone
    cv = BL_ref.constant_velocity_forecast(pos, vel, 0.25, 8)
    assert np.abs(np.asarray(want) - np.asarray(cv)).max() > 1e-2


SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=1)


def _models(cfg_kw, batch, ckpt=None):
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    key = jax.random.PRNGKey(0)
    params = ref.init({"params": key, "dropout": key},
                      jax.tree.map(jnp.asarray, batch), key)
    if ckpt is not None:
        params = MID_ref.load_checkpoint(os.path.abspath(ckpt), params)
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    port.load_state_dict(convert.jmid_state_dict(jax.tree.map(np.asarray,
                                                              params)))
    return ref, params, port


def _x_T(key, n, A):
    return t(jax.random.normal(jax.random.split(key)[0], (n * A, 8, 2)))


def test_eval_scene_one_key_for_a_batch():
    """fit's validation: one key for every scene of a batch."""
    ex = sim_examples()[:3]
    batch = D.stack_batches(ex)
    ref, params, port = _models(SMALL, ex[0])
    key = jax.random.PRNGKey(4)
    n = 6
    # the reference's fit vmaps eval_scene over the scenes with one key:
    # each scene is scored as alone with that key
    want = np.array([[float(x) for x in MID_ref.eval_scene(
        ref, params, jax.tree.map(jnp.asarray, one), key, n)] for one in ex]).T
    A = batch.hist.shape[1]
    got = MID.eval_scene(port, batch.to_tensors("cpu"), n,
                         x_T=_x_T(key, n, A))
    for g, w in zip(got, want):
        close(g, w, 1e-4)
    # the port's generator path draws one noise for all scenes too
    g = torch.Generator().manual_seed(0)
    a = MID.eval_scene(port, batch.to_tensors("cpu"), n, generator=g)
    b = MID.eval_scene(port, D.stack_batches([ex[2], ex[0], ex[1]]
                                             ).to_tensors("cpu"), n,
                       generator=torch.Generator().manual_seed(0))
    close(a[0][[2, 0, 1]], b[0], 1e-6)


def _full(ref, params, port, one, key, n):
    want = MID_ref.eval_scene_full(ref, params, jax.tree.map(jnp.asarray, one),
                                   key, n)
    got = MID.eval_scene_full(port, one.to_tensors("cpu"), n,
                              x_T=_x_T(key, n, one.hist.shape[0]))
    assert sorted(got) == sorted(want)
    return got, want


def _top_two(ref, params, one, key, n):
    """The two largest summed log-likelihoods of the reference's samples
    under the joint ranking that most_likely_ade_fde runs, in float64."""
    pred = ref.apply(params, jax.tree.map(jnp.asarray, one), key, n,
                     method=MID_ref.JMIDModel.sample)
    amask = one.agent_mask & one.fut_mask.any(-1)
    fc = torch.tensor(np.where(amask[None, :, None, None], np.asarray(pred),
                               0.0)).double()
    S, H, T, _ = fc.shape
    preds = fc.permute(2, 0, 1, 3).reshape(T, S, 2 * H)
    bw = torch.exp(torch.linspace(np.log(0.01), np.log(0.1), T,
                                  dtype=torch.float64))
    ll = K.kde_loglik_fused(preds, bw)
    lik = (ll - torch.logsumexp(ll, 1, keepdim=True)).sum(0)
    return torch.sort(lik).values[-2:].tolist()


ML = ("ml_ade", "ml_fde")


def test_eval_scene_full_small():
    """At random weights the 20 samples lie so far apart in the ranking's
    whitened units that every likelihood is its own self term: they tie,
    and the reference's pick is its rounding's. So the most-likely pair is
    held to the port's own rule for ties (its stable sort serves the last
    sample); every other metric to the reference."""
    ex = sim_examples(human_num=5, max_humans=5)
    ref, params, port = _models(SMALL, ex[0])
    key = jax.random.PRNGKey(9)
    for one in ex[:2]:
        key, k = jax.random.split(key)
        got, want = _full(ref, params, port, one, k, 20)
        for name in want:
            if name not in ML:
                close(got[name], want[name], 1e-4)
        assert np.isfinite([float(v) for v in got.values()]).all()
        lo, hi = _top_two(ref, params, one, k, 20)
        assert lo == hi
        tb = one.to_tensors("cpu")
        pred = port.sample(tb, 20, x_T=_x_T(k, 20, one.hist.shape[0]))
        gt = M.integrate_velocity_samples(tb.fut_vel, tb.hist[:, -1, :2],
                                          0.25)
        w = (tb.agent_mask & tb.fut_mask.any(-1)).float()
        err = torch.linalg.norm(pred[-1] - gt, dim=-1)
        ade = ((err * tb.fut_mask).sum(-1) / tb.fut_mask.sum(-1).clamp(min=1)
               * w).sum() / w.sum()
        close(got["ml_ade"], ade, 1e-6)


def test_hallway_checkpoint_scored_alike():
    """weights/jmid_hallway.npz scored by the port and the Orbax checkpoint
    by the reference, on hallway scenes from the port's sim, where the
    trained samples cluster and the ranking's top two stand apart."""
    ex = sim_examples(n_scenes=2, human_num=5, max_humans=5, seed=3)
    cfg_kw = dict(context_dim=128, tf_layer=2)
    ref, params, port = _models(cfg_kw, ex[0], CKPT)
    from_file = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    from_file.load_state_dict(convert.load_npz(WEIGHTS))
    key = jax.random.PRNGKey(1)
    for one in (ex[0], ex[3], ex[5]):
        key, k = jax.random.split(key)
        got, want = _full(ref, params, from_file, one, k, 20)
        lo, hi = _top_two(ref, params, one, k, 20)
        assert hi - lo > 1e-5, (lo, hi)
        for name in want:
            close(got[name], want[name], 1e-4)

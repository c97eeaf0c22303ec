"""Parity of the port's iMID predictor (``JMIDModel(joint=False)`` with
``TransformerConcatLinear``) with the JAX reference, at the shipped
``imid_eth_proof`` checkpoint's full width (context 256, three layers of
512 with 4 heads) and at small widths.

- ``weights/imid_eth_proof.npz``, read with numpy alone, against the Orbax
  checkpoint read by the reference: encode, denoise, and a DDIM sample
  from the reference's start noise, at the recipe's horizon 12 and at
  ``eval_prediction``'s 8 from one set of weights; and the file
  regenerates bit-equal from the checkpoint.
- ``eval_scene_full`` from the reference's noise on ETH-format scenes
  written by the port's synthesizer: every metric of the reference's
  sweep, and the per-agent most likely ADE / FDE (where the rankings tie,
  as they do for this checkpoint, by the port's rule for ties).
- The synthesizer's files read alike by the port's and the reference's
  ``load_ethucy_txt``.

Tolerance 1e-4 absolute, as ``tests/test_torch_jmid.py`` holds samples:
float32 reductions in other orders in XLA and PyTorch; the training loss
1e-5.
"""

import functools
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import data as DATA_ref
from sicnav_tpu.diffusion import kde as KDE_ref
from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import data as D
from sicnav_tpu_torch.diffusion import kde as KDE
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.ops import kde_cuda as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import synthesize_ethucy_torch as SYN  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
CKPT = os.path.join(ROOT, "checkpoints", "imid_eth_proof")
WEIGHTS = os.path.join(ROOT, "weights", "imid_eth_proof.npz")
WIDTHS = dict(context_dim=256, tf_layer=3)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@functools.lru_cache(maxsize=None)
def eth_dir():
    """A directory of this process's own for the synthesizer's files."""
    return tempfile.mkdtemp(prefix="eth_synth_")


@functools.lru_cache(maxsize=None)
def eth_examples(history_len=6, horizon=8):
    """Validation examples of ETH-format files from the port's synthesizer
    (4 crowds of 6 humans and the robot, 20 steps at dt 0.4), sliced as
    eval_prediction slices files."""
    args = SYN.parser().parse_args(["--out", eth_dir(), "--n_scenes", "4",
                                    "--rollouts_per_file", "2",
                                    "--steps", "20", "--val_fraction",
                                    "0.5"])
    paths = SYN.synthesize(args, "cpu")
    ex = []
    for f in paths["val"]:
        pos, valid = D.load_ethucy_txt(f)
        ex += D.build_examples(pos, valid, 0.4, history_len=history_len,
                               horizon=horizon, max_agents=16)
    return ex


def reference(cfg_kw, batch, ckpt=None, seed=0):
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=False)
    key = jax.random.PRNGKey(seed)
    params = ref.init({"params": key, "dropout": key},
                      jax.tree.map(jnp.asarray, batch), key)
    if ckpt is not None:
        params = MID_ref.load_checkpoint(os.path.abspath(ckpt), params)
    return ref, jax.tree.map(np.asarray, params)


def ref_sample(ref, n):
    """The reference's JMIDModel.sample of n samples, jitted."""
    return jax.jit(lambda p, b, k: ref.apply(p, b, k, n,
                                             method=MID_ref.JMIDModel.sample))


def port_model(cfg_kw, state_dict):
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), joint=False, device="cpu")
    port.load_state_dict(state_dict, strict=True)
    assert not port.denoiser_joint
    assert isinstance(port.denoiser, M.TransformerConcatLinear)
    return port


def x_T(key, n, A, T):
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.split(key)[0], (n * A, T, 2))))


@pytest.mark.parametrize("horizon", [8, 12])
def test_imid_eth_proof_full_width(horizon):
    """The shipped iMID checkpoint: the converted file against the
    reference at the recipe's horizon 12 (history 7) and at the sweep's 8
    (history 6)."""
    hist_len = 7 if horizon == 12 else 6
    batch = eth_examples(hist_len, horizon)[0]
    cfg_kw = dict(WIDTHS, history_len=hist_len, horizon=horizon)
    ref, params = reference(cfg_kw, batch, CKPT)
    port = port_model(cfg_kw, convert.load_npz(WEIGHTS))
    jb = jax.tree.map(jnp.asarray, batch)
    tb = batch.to_tensors("cpu")
    A = batch.hist.shape[0]

    ctx_ref = ref.apply(params, jb, method=MID_ref.JMIDModel.encode)
    ctx = port.encode(tb)
    close(ctx, ctx_ref)

    rng = np.random.default_rng(horizon)
    x = rng.normal(size=(2 * A, horizon, 2)).astype(np.float32)
    beta = np.full((2 * A,), 0.02, np.float32)
    ctx2 = np.concatenate([np.asarray(ctx_ref)] * 2)
    want = ref.apply(params, x, beta, ctx2, jb,
                     method=MID_ref.JMIDModel.denoise)
    got = port.denoise(torch.as_tensor(x), torch.as_tensor(beta),
                       torch.as_tensor(ctx2), tb)
    close(got, want)

    n, key = 4, jax.random.PRNGKey(horizon)
    want = ref_sample(ref, n)(params, jb, key)
    got = port.sample(tb, n, x_T=x_T(key, n, A, horizon))
    assert tuple(got.shape) == (n, A, horizon, 2)
    close(got, want)


def test_converted_imid_weights_regenerate():
    """scripts/convert_jmid_torch.py --name imid_eth_proof gives the
    committed file's arrays exactly."""
    import convert_jmid_torch as CJ
    widths, joint = CJ.MODELS["imid_eth_proof"]
    assert widths == WIDTHS and joint is False
    fresh = CJ.convert(os.path.abspath(CKPT), widths, joint)
    with np.load(WEIGHTS) as f:
        assert sorted(f.files) == sorted(fresh)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], fresh[k], err_msg=k)


def per_agent_gaps(pred, amask):
    """The gap between each agent's two most likely samples under the
    per-agent ranking, in float64."""
    fc = torch.tensor(np.where(amask[None, :, None, None], np.asarray(pred),
                               0.0)).double()
    S, A, T, _ = fc.shape
    ll = K.kde_loglik_fused(fc.permute(1, 2, 0, 3).reshape(A * T, S, 2),
                            0.05)
    lik = (ll - torch.logsumexp(ll, 1, keepdim=True)).reshape(A, T, S).sum(1)
    top = torch.sort(lik, dim=-1).values[:, -2:]
    return top[:, 1] - top[:, 0]


def joint_top_two(pred, amask):
    """The two largest summed log-likelihoods under the joint ranking that
    most_likely_ade_fde runs, in float64."""
    fc = torch.tensor(np.where(amask[None, :, None, None], pred, 0.0)).double()
    S, H, T, _ = fc.shape
    bw = torch.exp(torch.linspace(np.log(0.01), np.log(0.1), T,
                                  dtype=torch.float64))
    ll = K.kde_loglik_fused(fc.permute(2, 0, 1, 3).reshape(T, S, 2 * H), bw)
    lik = (ll - torch.logsumexp(ll, 1, keepdim=True)).sum(0)
    return torch.sort(lik).values[-2:].tolist()


def test_imid_eval_scene_full_from_reference_noise():
    """The trained iMID checkpoint scores ETH-format scenes alike: every
    metric of the reference's eval_scene_full from the reference's noise.

    Both rankings tie on these scenes. The reference's sweep ranks iMID
    samples jointly (T groups of 2A dimensions, up to 32 here), and the
    per-agent ranking (``most_likely_ade_fde(joint=False)``, A * T groups
    of 2) at bandwidth 0.05 against samples that spread over metres: in
    both every likelihood is its own self term, and all 20 tie (checked in
    float64). The reference's float32 distances break such ties by
    rounding, the port's (difference form, exact zeros) do not, and its
    stable sort serves the last sample. So ml_ade / ml_fde are held to
    that rule, and the per-agent pair to the port's ranking of the
    reference's samples, which where an agent's top two stand more than
    1e-5 apart must pick what the reference picks
    (``tests/test_torch_kde.py`` holds the per-agent ranking to the
    reference on samples that decide it)."""
    ex = eth_examples()
    ref, params = reference(WIDTHS, ex[0], CKPT)
    port = port_model(WIDTHS, convert.load_npz(WEIGHTS))
    key = jax.random.PRNGKey(3)
    n = 20
    ml = ("ml_ade", "ml_fde", "ml_ade_per_agent", "ml_fde_per_agent")
    for one in ex[:2]:
        key, k = jax.random.split(key)
        jb = jax.tree.map(jnp.asarray, one)
        want = MID_ref.eval_scene_full(ref, params, jb, k, n)
        A = one.hist.shape[0]
        tb = one.to_tensors("cpu")
        got = MID.eval_scene_full(port, tb, n, x_T=x_T(k, n, A, 8))
        assert set(got) == set(want) | set(ml)
        for name in want:
            if name not in ml:
                close(got[name], want[name])
        pred = np.asarray(ref_sample(ref, n)(params, jb, k))
        gt = np.asarray(M_ref.integrate_velocity_samples(
            jb.fut_vel[None], jb.hist[None, :, -1, 0:2], 0.25)[0])
        amask = one.agent_mask & one.fut_mask.any(-1)
        lo, hi = joint_top_two(pred, amask)
        assert lo == hi
        zeroed = np.where(amask[None, :, None, None], pred, 0.0)
        top_ref, _ = KDE_ref.most_likely_samples(jnp.asarray(zeroed), 1,
                                                 joint=False)
        top, _ = KDE.most_likely_samples(torch.as_tensor(zeroed), 1,
                                         joint=False)
        chosen = top[:, 0].numpy()                             # (A, T, 2)
        decided = (per_agent_gaps(pred, amask) > 1e-5).numpy() & amask
        np.testing.assert_array_equal(chosen[decided],
                                      np.asarray(top_ref)[decided, 0])

        def scored(best):
            err = np.linalg.norm(best - gt, axis=-1)
            sm = one.fut_mask.astype(np.float64)
            ade = (err * sm).sum(-1) / np.maximum(sm.sum(-1), 1)
            last = np.maximum(one.fut_mask.sum(-1) - 1, 0)
            fde = err[np.arange(A), last]
            w = amask.astype(np.float64)
            return (ade * w).sum() / w.sum(), (fde * w).sum() / w.sum()

        close(got["ml_ade_per_agent"], scored(chosen)[0])
        close(got["ml_fde_per_agent"], scored(chosen)[1])
        # the joint tie: every agent's last sample
        close(got["ml_ade"], scored(pred[-1])[0])
        close(got["ml_fde"], scored(pred[-1])[1])


def test_examples_load_through_the_reference_reader():
    """The synthesizer's files parse through the reference's own reader
    into the same examples as through the port's."""
    eth_examples()
    out = eth_dir()
    for split in ("train", "val"):
        files = sorted(os.listdir(os.path.join(out, split)))
        assert files and all(f.endswith(".txt") for f in files)
        for f in files:
            path = os.path.join(out, split, f)
            pos, valid = D.load_ethucy_txt(path)
            pos_r, valid_r = DATA_ref.load_ethucy_txt(path)
            np.testing.assert_array_equal(pos, pos_r)
            np.testing.assert_array_equal(valid, valid_r)
            rows = np.loadtxt(path, delimiter="\t")
            assert (rows[:, 0] % 10 == 0).all()
            # every track appears once per frame
            assert len({(r[0], r[1]) for r in rows}) == len(rows)

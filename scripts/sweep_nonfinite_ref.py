#!/usr/bin/env python3
"""Count the validation sweep's non-finite metrics in the JAX reference, on
the scenes and weights of a ``chip_smoke.py`` train phase.

    python scripts/sweep_nonfinite_ref.py [--dir build/train]
        [--encoder_dim 128] [--tf_layer 2] [--enc_rnn_dim 128]

The train phase writes ``sweep.npz`` (the validation scenes, the start
noise of each, and the card's and the CPU port's ``eval_scene_full``
metrics) and ``jmid_train.npz`` (the trained weights) under ``--dir``.
Here, on the CPU with JAX, the reference scores the same scenes twice:

- ``reference``: its own ``eval_scene_full`` with the weights mapped
  through ``convert.flax_params``, keys split from ``PRNGKey(7)`` per scene
  (train_jmid.py's ``--val_full``);
- ``reference ranking of the port's samples``: the port (CPU) samples from
  the phase's noise, and the reference's metrics (its KDE ranking
  included) score those samples: the same inputs the card ranked.

Prints one JSON object: per run, the non-finite count of each metric and
the KDE groups whose log-likelihoods are not all finite, beside the card's
and the CPU port's counts from the file. Needs JAX and Flax, which the
card's machine lacks: run it where the JAX package runs.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dir", default=os.path.join(ROOT, "build", "train"))
    p.add_argument("--encoder_dim", type=int, default=128)
    p.add_argument("--tf_layer", type=int, default=2)
    p.add_argument("--enc_rnn_dim", type=int, default=128)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch
    from sicnav_tpu.diffusion import evaluation as EV_ref
    from sicnav_tpu.diffusion import mid as MID_ref
    from sicnav_tpu.diffusion import models as M_ref
    from sicnav_tpu.diffusion.data import SceneBatch as SB_ref
    from sicnav_tpu.ops import kde_pallas as K_ref
    from sicnav_tpu_torch import convert
    from sicnav_tpu_torch.diffusion import mid as MID
    from sicnav_tpu_torch.diffusion import models as M
    from sicnav_tpu_torch.diffusion.data import SceneBatch

    f = np.load(os.path.join(args.dir, "sweep.npz"))
    scenes = SceneBatch(*[f["scene_" + k] for k in SceneBatch._fields])
    noises = f["noises"]
    metrics = [k[len("card_"):] for k in f.files if k.startswith("card_")]
    cfg_kw = dict(context_dim=args.encoder_dim, tf_layer=args.tf_layer,
                  enc_rnn_dim=args.enc_rnn_dim)
    sd = convert.load_npz(os.path.join(args.dir, "jmid_train.npz"))
    port = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    port.load_state_dict(sd)
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    params = jax.tree.map(jnp.asarray, convert.flax_params(
        sd, M.ModelConfig(**cfg_kw).n_heads))
    n_samples = noises.shape[1] // scenes.agent_mask.shape[1]

    def kde_bad(pred, amask):
        """Groups of the joint ranking whose log-likelihoods are not all
        finite, for the samples (S, A, T, 2) as most_likely_ade_fde ranks
        them (absent agents zeroed)."""
        fc = jnp.where(jnp.asarray(amask)[None, :, None, None], pred, 0.0)
        S, H, T, _ = fc.shape
        preds = jnp.transpose(fc, (2, 0, 1, 3)).reshape(T, S, H * 2)
        bw = jnp.exp(jnp.linspace(np.log(0.01), np.log(0.1), T))
        ll = np.asarray(K_ref.kde_loglik_fused(preds, bw))
        return int((~np.isfinite(ll).all(-1)).sum())

    runs = {"reference": {k: [] for k in metrics},
            "reference_on_port_samples": {"ml_ade": [], "ml_fde": []}}
    bad = {"reference": 0, "reference_on_port_samples": 0}
    key = jax.random.PRNGKey(7)
    full = jax.jit(MID_ref.eval_scene_full, static_argnames=("model",
                                                             "n_samples"))
    sample = jax.jit(lambda p, b, k: ref.apply(
        p, b, k, n_samples, method=MID_ref.JMIDModel.sample))
    for i in range(scenes.hist.shape[0]):
        one = SB_ref(*[np.asarray(x[i]) for x in scenes])
        jb = jax.tree.map(jnp.asarray, one)
        amask = one.agent_mask & one.fut_mask.any(-1)
        key, k = jax.random.split(key)
        m = full(ref, params, jb, k, n_samples)
        for name in metrics:
            runs["reference"][name].append(float(m[name]))
        bad["reference"] += kde_bad(sample(params, jb, k), amask)
        pred = port.sample(SceneBatch(*[torch.as_tensor(x) for x in one]),
                           n_samples, x_T=torch.as_tensor(noises[i]))
        pred = jnp.asarray(pred.numpy())
        p0 = jnp.asarray(one.hist[:, -1, 0:2])
        gt = p0[:, None] + jnp.cumsum(jnp.asarray(one.fut_vel), -2) * 0.25
        ml = EV_ref.most_likely_ade_fde(pred, gt, agent_mask=amask,
                                        step_mask=one.fut_mask)
        runs["reference_on_port_samples"]["ml_ade"].append(float(ml[0]))
        runs["reference_on_port_samples"]["ml_fde"].append(float(ml[1]))
        bad["reference_on_port_samples"] += kde_bad(pred, amask)

    out = {"scenes": int(scenes.hist.shape[0])}
    for name, run in runs.items():
        out[name] = {"non_finite": {k: int(np.sum(~np.isfinite(v)))
                                    for k, v in run.items()},
                     "kde_groups_non_finite": bad[name],
                     "mean": {k: float(np.nanmean(v)) for k, v in
                              run.items()}}
    for side in ("card", "cpu"):
        out[side] = {"non_finite": {k: int(np.sum(~np.isfinite(
            f[f"{side}_{k}"]))) for k in metrics},
            "mean": {k: float(np.nanmean(f[f"{side}_{k}"]))
                     for k in metrics}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Paired per-agent comparison of the per-node-type dispatch encoder
against its ``--no_dispatch`` ablation on the PyTorch port (twin of
scripts/eval_dispatch_paired.py), on the SAME validation scenes with the
SAME sampling noise.

    python scripts/eval_dispatch_paired_torch.py \
        --ckpt_dispatch build/jmid_mc_man.npz \
        --ckpt_no_dispatch build/jmid_mc_man_nod.npz

Takes every option of the reference script. Both checkpoints are ``.npz``
files of the port's state_dict from ``scripts/train_jmid_torch.py
--multi_class --class_mode maneuver`` runs at the default widths (256, 3
layers): the dispatch one with ``num_node_types=3``, the ablation with
``--no_dispatch``. The validation split is rebuilt as train_jmid_torch.py
builds it (``generate_sim_scenes`` and ``split_examples`` with the same
``--n_scenes`` and ``--seed``), and each example is sampled by both models
from one start noise, drawn from a generator whose seed comes from a
generator seeded ``--seed`` + 13, so the per-agent ADE / FDE differences
are paired. Per node type it prints, as one JSON object, the mean paired
difference (> 0: dispatch better), its standard error, the
normal-approximation 95 % CI and the win fraction, per agent and
clustered by scene, and the ADE over all agents. Runs on CUDA unless
``--device cpu`` (port only). Imports no JAX.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--ckpt_dispatch",
                   default=os.path.join("build", "jmid_mc_man.npz"))
    p.add_argument("--ckpt_no_dispatch",
                   default=os.path.join("build", "jmid_mc_man_nod.npz"))
    p.add_argument("--class_mode", default="maneuver",
                   choices=["speed", "maneuver"])
    p.add_argument("--n_scenes", type=int, default=320,
                   help="must match the training run for an identical "
                        "val split")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--max_examples", type=int, default=0,
                   help="cap val examples (0 = all)")
    p.add_argument("--scenario", default="circle_crossing")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p.parse_args(argv)


def val_split(args, device):
    """The validation examples of train_jmid_torch.py --multi_class at
    these --n_scenes, --seed, --scenario and --class_mode."""
    import train_jmid_torch as TJ
    examples = TJ.generate_sim_scenes(
        args.n_scenes, TJ.sim_env_config(args.scenario), args.seed,
        multi_class=True, class_mode=args.class_mode, device=device)
    val, _ = TJ.split_examples(examples, args.seed)
    return val[:args.max_examples] if args.max_examples else val


def load_model(num_node_types, path, device):
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    model = JMIDModel(ModelConfig(context_dim=256, tf_layer=3,
                                  num_node_types=num_node_types),
                      joint=True, device=device)
    model.load_state_dict(load_npz(os.path.abspath(path)))
    return model


def paired_diffs(val, m_d, m_n, num_samples, seed, device):
    """Per node type, the per-agent and per-scene paired differences
    (no-dispatch minus dispatch) of min-of-k ADE and FDE."""
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion.mid import eval_scene_per_agent

    seeds = torch.Generator().manual_seed(seed + 13)
    diffs = {t: {"ade": [], "fde": []} for t in D.NODE_TYPES}
    # per-scene mean diffs: scenes are independent draws, the agents of a
    # scene are not
    scene_diffs = {t: {"ade": [], "fde": []} for t in D.NODE_TYPES}
    for i, ex in enumerate(val):
        batch = ex.to_tensors(device)
        A = batch.agent_mask.shape[-1]
        gen = torch.Generator(device=device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=seeds)))
        x_T = torch.randn((num_samples * A, m_d.cfg.horizon, 2),
                          generator=gen, device=device)
        a_d, f_d, ok = (x.cpu().numpy() for x in eval_scene_per_agent(
            m_d, batch, num_samples, x_T=x_T))
        a_n, f_n, _ = (x.cpu().numpy() for x in eval_scene_per_agent(
            m_n, batch, num_samples, x_T=x_T))
        ty = np.asarray(ex.types())
        da = a_n - a_d           # > 0: dispatch better
        df = f_n - f_d
        for ti, tn in enumerate(D.NODE_TYPES):
            m = ok & (ty == ti)
            diffs[tn]["ade"] += da[m].tolist()
            diffs[tn]["fde"] += df[m].tolist()
            if m.any():
                scene_diffs[tn]["ade"].append(float(da[m].mean()))
                scene_diffs[tn]["fde"].append(float(df[m].mean()))
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(val)}", file=sys.stderr)
    return diffs, scene_diffs


def paired_stats(diffs, scene_diffs):
    """The report: per node type and metric the paired mean, standard
    error, 95 % CI and win fraction, per agent and scene-clustered; and
    the ADE over all agents."""
    out = {}
    for tn, v in diffs.items():
        row = {}
        for metric, d in v.items():
            d = np.asarray(d)
            if not len(d):
                row[metric] = None
                continue
            se = float(d.std(ddof=1) / np.sqrt(len(d)))
            mu = float(d.mean())
            sd = np.asarray(scene_diffs[tn][metric])
            sse = float(sd.std(ddof=1) / np.sqrt(len(sd)))
            smu = float(sd.mean())
            row[metric] = {"n": int(len(d)),
                           "mean_paired_diff": mu, "se": se,
                           "ci95": [mu - 1.96 * se, mu + 1.96 * se],
                           "win_frac": float((d > 0).mean()),
                           "scene_clustered": {
                               "n_scenes": int(len(sd)),
                               "mean": smu, "se": sse,
                               "ci95": [smu - 1.96 * sse,
                                        smu + 1.96 * sse],
                               "scene_win_frac": float((sd > 0).mean())}}
        out[tn] = row
    alla = np.asarray(sum((v["ade"] for v in diffs.values()), []))
    out["ALL"] = {"ade_mean_paired_diff": float(alla.mean()),
                  "ade_se": float(alla.std(ddof=1) / np.sqrt(len(alla))),
                  "n": int(len(alla))}
    return out


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    val = val_split(args, device)
    print(json.dumps({"val_examples": len(val)}), file=sys.stderr)
    m_d = load_model(3, args.ckpt_dispatch, device)
    m_n = load_model(1, args.ckpt_no_dispatch, device)
    out = paired_stats(*paired_diffs(val, m_d, m_n, args.num_samples,
                                     args.seed, device))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

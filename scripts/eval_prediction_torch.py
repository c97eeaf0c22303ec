#!/usr/bin/env python3
"""Evaluate trajectory predictors with the PyTorch port (twin of
``scripts/eval_prediction.py``): a JMID or iMID checkpoint of the port
(``--method mid_jp|mid --weights X.npz``) or the constant-velocity,
collision-fixed constant-velocity and standing baselines (``cv``,
``cv_fix``, ``standing``), with ADE / FDE / SADE / SFDE on the same
scenes.

    python scripts/eval_prediction_torch.py --method mid_jp \\
        --weights weights/jmid_hallway.npz --encoder_dim 128 --tf_layer 2 \\
        --scenario hallway_bottleneck [--full] [--time] [--device cpu]
    python scripts/eval_prediction_torch.py --method mid \\
        --weights weights/imid_eth_proof.npz --encoder_dim 256 --tf_layer 3 \\
        --data_files data/eth_synth/val/*.txt --full

Scenes are sim rollouts (``train_jmid_torch.generate_sim_scenes`` with
seed ``--seed + 10000``, so they are not the training scenes) or
ETH/UCY-style files (``--data_files``). ``--full`` adds the most-likely
ADE / FDE (the KDE ranking, on the hand-written kernel on the card),
KDE-NLL, the horizon-fraction ADEs, the obstacle-violation rate (hallway
scenarios) and the NFE count; for ``--method mid`` also the most-likely
ADE / FDE of each agent's own ranking (``ml_ade_per_agent``,
``ml_fde_per_agent``: A x T KDE groups of two dimensions, beside the
reference's joint ranking). ``--time`` measures one scene's sampling
latency instead. ``--num_node_types > 1`` serves a class-conditioned
checkpoint and adds the per-class ADE / FDE. Prints one JSON object. Runs
on the card unless ``--device cpu``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def baseline_forecast(batch, method, dt, horizon):
    """SceneBatch of tensors -> (A, T, 2) positions from a baseline."""
    from sicnav_tpu_torch.diffusion import baselines as BL
    pos = batch.hist[:, -1, 0:2]
    vel = batch.hist[:, -1, 2:4]
    if method == "standing":
        return BL.standing_forecast(pos, horizon)
    if method == "cv":
        return BL.constant_velocity_forecast(pos, vel, dt, horizon)
    radius = torch.full((pos.shape[0],), 0.3, device=pos.device)
    return BL.cv_collision_fixed_forecast(pos, vel, radius, batch.agent_mask,
                                          dt, horizon)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    from train_jmid_torch import generate_sim_scenes, load_files, \
        per_class_scores, sim_env_config

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--method", default="cv",
                   choices=["mid", "mid_jp", "cv", "cv_fix", "standing"])
    p.add_argument("--weights", "--checkpoint", dest="weights", default=None,
                   help="the port's .npz checkpoint (train_jmid_torch.py)")
    p.add_argument("--data_files", nargs="*", default=[])
    p.add_argument("--n_scenes", type=int, default=32)
    p.add_argument("--scenario", default="circle_crossing")
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--encoder_dim", type=int, default=256)
    p.add_argument("--num_node_types", type=int, default=1)
    p.add_argument("--tf_layer", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true")
    p.add_argument("--time", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.diffusion import evaluation as EV
    from sicnav_tpu_torch.diffusion.diffusion import nfe_count
    from sicnav_tpu_torch.diffusion.mid import (JMIDModel, eval_scene,
                                                eval_scene_full)
    from sicnav_tpu_torch.diffusion.models import (
        ModelConfig, integrate_velocity_samples)

    device = resolve_device(args.device)
    dt = 0.25
    env_cfg = None
    if args.data_files:
        dt = 0.4
        examples = load_files(args.data_files, dt)
    else:
        env_cfg = sim_env_config(args.scenario)
        examples = generate_sim_scenes(args.n_scenes, env_cfg,
                                       args.seed + 10_000, device=device)

    model = None
    if args.method in ("mid", "mid_jp"):
        model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                      tf_layer=args.tf_layer,
                                      num_node_types=args.num_node_types),
                          joint=args.method == "mid_jp", device=device)
        model.load_state_dict(load_npz(args.weights))
    gen = torch.Generator(device=device).manual_seed(args.seed)

    if args.time and model is not None:
        b0 = examples[0].to_tensors(device)
        model.sample(b0, args.num_samples, generator=gen)
        times = []
        for _ in range(20):
            _sync(device)
            t0 = time.perf_counter()
            model.sample(b0, args.num_samples, generator=gen)
            _sync(device)
            times.append(time.perf_counter() - t0)
        print(json.dumps({
            "method": args.method, "device": str(device),
            "inference_ms_p50": float(1e3 * np.median(times)),
            "inference_ms_p95": float(1e3 * np.percentile(times, 95)),
            "num_samples": args.num_samples, "nfe": nfe_count()}))
        return 0

    walls = None
    if model is not None and args.full and env_cfg is not None and \
            args.scenario.startswith("hallway"):
        from sicnav_tpu_torch.env.walls import build_walls
        w, wm, _ = build_walls(env_cfg)
        walls = (torch.as_tensor(w, device=device),
                 torch.as_tensor(wm, device=device))

    scores = {k: [] for k in ("ade", "fde", "sade", "sfde")}
    extra = {k: [] for k in ("ml_ade", "ml_fde", "ml_ade_per_agent",
                             "ml_fde_per_agent", "kde_nll", "ade_one_fourth",
                             "ade_two_fourth", "ade_three_fourth",
                             "obs_violation_rate")}
    for ex in examples:
        gt_valid = ex.agent_mask & ex.fut_mask.all(axis=-1)
        if not gt_valid.any():
            continue
        batch = ex.to_tensors(device)
        horizon = batch.fut_vel.shape[-2]
        gt = integrate_velocity_samples(batch.fut_vel, batch.hist[:, -1, 0:2],
                                        dt)
        valid = torch.as_tensor(gt_valid, device=device)
        if model is not None and args.full:
            m = eval_scene_full(model, batch, args.num_samples, gen)
            a, f, sa, sf = m["ade"], m["fde"], m["sade"], m["sfde"]
            for k in extra:
                if k in m:
                    extra[k].append(float(m[k]))
            if walls is not None:
                pred = model.sample(batch, args.num_samples, generator=gen)
                viol = EV.obstacle_violations(pred.movedim(-4, -3), *walls,
                                              0.3)
                w = valid.float()
                extra["obs_violation_rate"].append(
                    float((viol * w).sum() / w.sum()))
        elif model is not None:
            a, f, sa, sf = eval_scene(model, batch, args.num_samples, gen)
        else:
            pred = baseline_forecast(batch, args.method, dt, horizon)
            w = valid.float()
            a = (EV.ade(pred[:, None], gt)[:, 0] * w).sum() / w.sum()
            f = (EV.fde(pred[:, None], gt)[:, 0] * w).sum() / w.sum()
            sa, sf = EV.scene_ade_fde(pred[None], gt, valid)
        for k, v in zip(("ade", "fde", "sade", "sfde"), (a, f, sa, sf)):
            scores[k].append(float(v))

    out = {"method": args.method, "num_scenes": len(scores["ade"]),
           "device": str(device)}
    out.update({k: float(np.mean(v)) for k, v in scores.items()})
    if model is not None and args.num_node_types > 1:
        out["per_class"] = per_class_scores(model, examples,
                                            args.num_samples, device,
                                            args.seed + 99)
    if args.full:
        for k, v in extra.items():
            if v:
                out[k] = float(np.mean(v))
                n_bad = int(np.sum(~np.isfinite(v)))
                if n_bad:
                    out[k + "_non_finite"] = n_bad
        out["nfe"] = nfe_count()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

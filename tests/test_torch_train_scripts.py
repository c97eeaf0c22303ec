"""Rehearsals of the port's training and prediction-evaluation entry
points on the CPU, small: ``scripts/train_jmid_torch.py`` writes an
``.npz`` that ``convert.load_npz`` and ``sicnav_diffusion.make_policy``
take and ``scripts/eval_prediction_torch.py --full`` scores, and
``chip_smoke.phase_train`` runs its path (its CUDA-only checks run on the
card)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, ROOT)

import eval_prediction_torch  # noqa: E402
import train_jmid_torch  # noqa: E402

torch.set_num_threads(2)
SMALL_ARGS = ["--encoder_dim", "32", "--tf_layer", "1"]


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines()
            if x.startswith(("{", "["))]


def test_train_then_serve_then_score(tmp_path, capsys):
    out = tmp_path / "jmid.npz"
    assert train_jmid_torch.main(
        ["--device", "cpu", "--n_scenes", "4", "--epochs", "1",
         "--scenario", "hallway_bottleneck", "--val_full", "--out", str(out),
         "--log_dir", str(tmp_path / "log")] + SMALL_ARGS) == 0
    summary, last, sweep = _json_lines(capsys.readouterr().out)
    assert summary["epochs_run"] == 1
    assert len(last) == 1 and np.isfinite(last[0]["loss"])
    assert set(sweep) >= {"ade", "ml_ade", "kde_nll", "ade_three_fourth",
                          "non_finite"}
    assert (tmp_path / "log" / "jmid.jsonl").exists()

    sd = convert.load_npz(str(out))
    cfg = M.ModelConfig(context_dim=32, tf_layer=1)
    model = MID.JMIDModel(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
    env = EnvConfig(scenario="hallway_bottleneck", human_num=3, max_humans=3,
                    starts_moving=0, robot_kinematics="unicycle")
    fcfg = FC.ForecasterConfig(num_samples=8, num_ret_samples=4,
                               ddim_stride=25, dt=env.dt)
    ocp, _ = SD.make_policy(env, model, fcfg=fcfg, device="cpu")
    state = CS.reset_host(env, 0, device="cpu")
    fstate = FC.update_state_hists(FC.init_state(3, fcfg, device="cpu"),
                                   state, fcfg)
    fc, lw = FC.predict_ret_best(model, fstate, state, fcfg,
                                 generator=torch.Generator().manual_seed(0))
    assert tuple(fc.shape) == (3, 4, 9, 2) and bool(torch.isfinite(fc).all())

    assert eval_prediction_torch.main(
        ["--device", "cpu", "--method", "mid_jp", "--weights", str(out),
         "--n_scenes", "1", "--scenario", "hallway_bottleneck", "--full",
         "--num_samples", "8"] + SMALL_ARGS) == 0
    (scores,) = _json_lines(capsys.readouterr().out)
    assert scores["num_scenes"] > 0 and scores["nfe"] == 50
    for k in ("ade", "fde", "sade", "sfde", "ml_ade", "ml_fde", "kde_nll",
              "obs_violation_rate"):
        assert np.isfinite(scores[k]), k


@pytest.mark.parametrize("method", ["cv", "cv_fix", "standing"])
def test_baselines_score(method, capsys):
    assert eval_prediction_torch.main(
        ["--device", "cpu", "--method", method, "--n_scenes", "2",
         "--scenario", "hallway_bottleneck"]) == 0
    (scores,) = _json_lines(capsys.readouterr().out)
    assert scores["num_scenes"] > 0
    assert 0 < scores["ade"] < scores["fde"] + 1.0


TRAIN_ARGS = ["--device", "cpu", "--n_scenes", "4", "--epochs", "1",
              "--encoder_dim", "16", "--tf_layer", "1"]


@pytest.mark.parametrize("argv", [
    ["--method", "mid"],
    ["--multi_class"],
    ["--multi_class", "--class_mode", "maneuver"],
    ["--multi_class", "--no_dispatch"],
], ids=["imid", "multi_class", "maneuver", "no_dispatch"])
def test_train_options_run(argv, tmp_path, capsys):
    """Every option of train_jmid.py trains on the CPU: iMID, and the
    multi-class sim with and without the class-conditioned encoder, each
    with its per-class validation scores."""
    out = tmp_path / "m.npz"
    assert train_jmid_torch.main(TRAIN_ARGS + ["--out", str(out)] +
                                 argv) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0]["epochs_run"] == 1
    sd = convert.load_npz(str(out))
    classes = "--multi_class" in argv and "--no_dispatch" not in argv
    assert ("encoder.class_embed.weight" in sd) == classes
    cfg = M.ModelConfig(context_dim=16, tf_layer=1,
                        num_node_types=3 if classes else 1)
    model = MID.JMIDModel(cfg, joint="--method" not in argv, device="cpu")
    model.load_state_dict(sd, strict=True)
    if "--multi_class" in argv:
        per_class = lines[-1]["per_class"]
        assert per_class["PEDESTRIAN"]["n"] > 0
        assert per_class["ROBOT"]["n"] > 0
        for v in per_class.values():
            assert v["n"] == 0 or np.isfinite(v["ade"])


@pytest.mark.parametrize("class_mode", ["speed", "maneuver"])
def test_multi_class_sim_scenes(class_mode):
    """Typed sim scenes: bicycles among the humans, the robot the last
    track; bicycles faster (speed) or at the same speed (maneuver)."""
    from sicnav_tpu_torch.diffusion import data as D
    cfg = train_jmid_torch.sim_env_config("circle_crossing")
    ex = train_jmid_torch.generate_sim_scenes(
        6, cfg, seed=1, multi_class=True, class_mode=class_mode,
        device="cpu")
    types = np.stack([e.node_type for e in ex])
    present = np.stack([e.agent_mask for e in ex])
    assert types.shape[1] == cfg.max_humans + 1
    assert (types[:, -1] == D.NODE_TYPES.index("ROBOT")).all()
    assert (types[:, :-1] != D.NODE_TYPES.index("ROBOT")).all()
    assert (types[present] == D.NODE_TYPES.index("BICYCLE")).any()
    plain = train_jmid_torch.generate_sim_scenes(6, cfg, seed=1,
                                                 device="cpu")
    assert plain[0].hist.shape[0] == cfg.max_humans
    assert all((e.node_type == 0).all() for e in plain)


@pytest.fixture(scope="module")
def eth_files(tmp_path_factory):
    import synthesize_ethucy_torch as SYN
    out = tmp_path_factory.mktemp("eth")
    args = SYN.parser().parse_args(["--out", str(out), "--n_scenes", "4",
                                    "--rollouts_per_file", "2",
                                    "--steps", "32", "--val_fraction",
                                    "0.5", "--hard"])
    return SYN.synthesize(args, "cpu")


def test_recipe_on_eth_files_then_imid_scores(eth_files, tmp_path, capsys,
                                             monkeypatch):
    """The ETH iMID recipe on synthesized ETH-format files: the recipe's
    history 7, horizon 12, frame period, learning rate and batch size (as
    far as the data reaches), at small widths here (the recipe's own, 256
    wide, train on the card in chip_smoke.py's imid phase); then the
    weights served by eval_prediction_torch.py --method mid --full at
    history 6, horizon 8, with the per-agent ranking beside the joint
    one."""
    from sicnav_tpu_torch.diffusion import recipes as R
    name = "ddim_p3_bs256_lr001_eth"
    recipe = R.get_recipe(name)
    monkeypatch.setitem(R.RECIPES, name, dataclasses.replace(
        recipe, model=dataclasses.replace(recipe.model, context_dim=16,
                                          tf_layer=1)))
    out = tmp_path / "imid.npz"
    assert train_jmid_torch.main(
        ["--device", "cpu", "--recipe", name, "--epochs", "1",
         "--data_files", *eth_files["train"], "--val_data_files",
         *eth_files["val"], "--out", str(out)]) == 0
    captured = capsys.readouterr()
    counts = _json_lines(captured.err)[0]
    assert counts["train_batches"] == 1          # min(256, examples)
    assert counts["train_examples"] < recipe.train.batch_size
    summary = _json_lines(captured.out)[0]
    assert summary["epochs_run"] == 1
    model = MID.JMIDModel(R.get_recipe(name).model, joint=False,
                          device="cpu")
    model.load_state_dict(convert.load_npz(str(out)), strict=True)
    assert eval_prediction_torch.main(
        ["--device", "cpu", "--method", "mid", "--checkpoint", str(out),
         "--encoder_dim", "16", "--tf_layer", "1", "--data_files",
         *eth_files["val"], "--full", "--num_samples", "6"]) == 0
    (scores,) = _json_lines(capsys.readouterr().out)
    assert scores["num_scenes"] > 0 and scores["nfe"] == 50
    for k in ("ade", "fde", "ml_ade", "ml_ade_per_agent", "ml_fde_per_agent",
              "kde_nll"):
        assert np.isfinite(scores[k]), k


def test_eval_class_conditioned_per_class(tmp_path, capsys):
    """eval_prediction_torch.py --num_node_types 3 serves a
    class-conditioned checkpoint and breaks the scores down per class."""
    out = tmp_path / "mc.npz"
    assert train_jmid_torch.main(TRAIN_ARGS + ["--multi_class", "--out",
                                               str(out)]) == 0
    capsys.readouterr()
    assert eval_prediction_torch.main(
        ["--device", "cpu", "--method", "mid_jp", "--num_node_types", "3",
         "--weights", str(out), "--encoder_dim", "16", "--tf_layer", "1",
         "--n_scenes", "2", "--num_samples", "4"]) == 0
    (scores,) = _json_lines(capsys.readouterr().out)
    assert set(scores["per_class"]) == {"PEDESTRIAN", "BICYCLE", "ROBOT"}
    assert scores["per_class"]["PEDESTRIAN"]["n"] > 0


def test_chip_smoke_train_rehearsal(tmp_path):
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda as K
    launches = chip_smoke.phase_train(
        K, device="cpu", mcfg=M.ModelConfig(context_dim=32, enc_rnn_dim=16,
                                            tf_layer=1),
        n_scenes=8, epochs=1, out_dir=str(tmp_path))
    assert launches == 0          # CPU tensors take the plain version
    assert (tmp_path / "jmid_train.npz").exists()

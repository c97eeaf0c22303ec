"""Rehearsals of the port's training and prediction-evaluation entry
points on the CPU, small: ``scripts/train_jmid_torch.py`` writes an
``.npz`` that ``convert.load_npz`` and ``sicnav_diffusion.make_policy``
take and ``scripts/eval_prediction_torch.py --full`` scores, and
``chip_smoke.phase_train`` runs its path (its CUDA-only checks run on the
card)."""

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


def test_unported_options_raise():
    for argv in (["--method", "mid"], ["--multi_class"],
                 ["--class_mode", "maneuver"], ["--no_dispatch"],
                 ["--recipe", "ddim_p3_bs256_lr001_eth"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            train_jmid_torch.main(["--device", "cpu"] + argv)
    for argv in (["--method", "mid"], ["--num_node_types", "3"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            eval_prediction_torch.main(["--device", "cpu"] + argv)


def test_chip_smoke_train_rehearsal(tmp_path):
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda as K
    launches = chip_smoke.phase_train(
        K, device="cpu", mcfg=M.ModelConfig(context_dim=32, enc_rnn_dim=16,
                                            tf_layer=1),
        n_scenes=8, epochs=1, out_dir=str(tmp_path))
    assert launches == 0          # CPU tensors take the plain version
    assert (tmp_path / "jmid_train.npz").exists()

"""The port's single-episode runner (scripts/simple_test_torch.py) against
the reference's (scripts/simple_test.py).

- The slice as a whole: both scripts' DWA episode of hallway-bottleneck
  host case 0 from configs/env.config. The per-step event flags are equal;
  the robot's positions, the rewards and dmin agree within 1e-4; the
  summaries have the same keys and the same outcome and counts.
- ``--policy campc --debug_pickle`` for one step at ``--ipm_iters 2`` (the
  port alone: the reference's controller is not compiled here): the
  pickle's keys are the reference script's, key for key (read from its
  source), and every trace row is finite.
- ``--video`` of the fused controller writes a gif with one frame per
  state (skips without matplotlib).
"""

import ast
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

import sicnav_tpu.env.crowd_sim as CS_ref
import sicnav_tpu_torch.env.crowd_sim as CS
from sicnav_tpu.mpc import introspection as IN_ref
from sicnav_tpu.mpc import ipm as ipm_ref

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import simple_test as ST_ref  # noqa: E402
import simple_test_torch as ST  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
DWA = ["--policy", "dwa", "--hallway_bottleneck", "--env_config",
       str(ROOT / "configs" / "env.config")]
FLAGS = ("collision", "danger", "frozen", "wall_collision")


def _reference_dict_keys(marker):
    """The keyword names of the ``dict(...)`` call in scripts/simple_test.py
    that has the keyword ``marker``."""
    tree = ast.parse((ROOT / "scripts" / "simple_test.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "dict" and marker in {k.arg for k in node.keywords}:
            return {k.arg for k in node.keywords}
    raise AssertionError(marker)


def test_dwa_episode_matches_reference(tmp_path, monkeypatch):
    ref_pos = []
    ref_step = CS_ref.step

    def recording(state, action, cfg):
        out = ref_step(state, action, cfg)
        ref_pos.append(np.asarray(out[0].r_pos))
        return out

    monkeypatch.setattr(CS_ref, "step", recording)
    ref_pkl = tmp_path / "ref.pkl"
    monkeypatch.setattr(sys, "argv", ["simple_test.py", *DWA,
                                      "--output_pickle", str(ref_pkl)])
    ST_ref.main()
    with open(ref_pkl, "rb") as f:
        want = pickle.load(f)

    port_pos = []
    port_step = CS.step

    def recording_port(state, action, cfg):
        out = port_step(state, action, cfg)
        port_pos.append(out[0].r_pos.numpy())
        return out

    monkeypatch.setattr(CS, "step", recording_port)
    port_pkl = tmp_path / "port.pkl"
    got = ST.main([*DWA, "--output_pickle", str(port_pkl), "--device",
                   "cpu"])
    with open(port_pkl, "rb") as f:
        assert pickle.load(f) == got

    assert set(got) == set(want) == _reference_dict_keys("wall_time")
    for k in ("policy", "test_case", "success", "timeout", "steps",
              "collisions", "wall_collisions", "frozen", "danger"):
        assert got[k] == want[k], k
    assert abs(got["nav_time"] - want["nav_time"]) <= TOL
    assert len(got["log"]) == len(want["log"]) == len(port_pos) == \
        len(ref_pos)
    for e, r in zip(got["log"], want["log"]):
        assert set(e) == set(r)
        assert e["step"] == r["step"]
        assert all(e[k] == r[k] for k in FLAGS), (e, r)
        for k in ("t", "reward", "dmin"):
            assert abs(e[k] - r[k]) <= TOL, (k, e, r)
    np.testing.assert_allclose(np.stack(port_pos), np.stack(ref_pos),
                               rtol=0, atol=TOL)


def test_debug_pickle_schema(tmp_path):
    path = tmp_path / "debug.pkl"
    summary = ST.main(["--policy", "campc", "--ipm_iters", "2",
                       "--debug_pickle", str(path), "--device", "cpu"],
                      max_steps=1)
    with open(path, "rb") as f:
        dbg = pickle.load(f)
    assert set(dbg) == {"summary", "solves"} and dbg["summary"] == summary
    assert set(summary) == _reference_dict_keys("wall_time")
    (solve,) = dbg["solves"]
    assert set(solve) == _reference_dict_keys("viol_sol")
    assert set(solve["trace"]) == set(IN_ref.IterTrace._fields)
    for v in solve["trace"].values():
        assert v.shape == (2,) and np.isfinite(v).all()
    assert set(solve["info"]) == set(ipm_ref.IPMInfo._fields)
    assert set(solve["viol_sol"]) == set(solve["viol_used"])
    assert {"coll", "stat", "kkt"} <= set(solve["viol_sol"])
    assert set(solve["worst"]) == {"name", "value", "row"}
    assert solve["worst"]["name"] in solve["viol_used"]
    assert isinstance(solve["used_guess"], bool)
    for k in ("sol_cost", "guess_cost", "slack_max"):
        assert isinstance(solve[k], float)


def test_video_of_the_fused_controller(tmp_path):
    pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    path = tmp_path / "episode.gif"
    summary = ST.main(["--policy", "sicnav_diffusion", "--ipm_iters", "2",
                       "--video", str(path), "--device", "cpu"],
                      max_steps=2)
    assert summary["steps"] == 2
    assert Image.open(path).n_frames == 3

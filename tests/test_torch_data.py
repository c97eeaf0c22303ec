"""Parity of the port's dataset construction (``diffusion/data.py``) with
the JAX reference's: both are numpy, so every example must be equal to the
bit. Scenes come from the reference's env rollout, from synthetic tracks
with gaps, and from ETH/UCY and JRDB-style files written to ``tmp_path``.
"""

import jax
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import data as D_ref
from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import rollout as R_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.policies import orca_robot as OR_ref
from sicnav_tpu_torch.diffusion import data as D


def assert_batches_equal(got, want):
    assert type(got).__name__ == "SceneBatch"
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
            continue
        assert isinstance(g, np.ndarray), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def tracks(seed, A=7, T=30):
    """Tracks with agents that enter late, leave early and skip frames."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.1, (A, T, 2)), axis=1).astype(np.float32)
    valid = np.ones((A, T), bool)
    valid[1, :9] = False
    valid[2, 20:] = False
    valid[3, 12:14] = False
    valid[4] = False
    return pos, valid


@pytest.mark.parametrize("kw", [dict(), dict(max_agents=4),
                                dict(max_agents=10, stride=3),
                                dict(history_len=4, horizon=6)])
def test_build_examples(kw):
    pos, valid = tracks(0)
    types = np.array([0, 1, 2, 0, 1, 0, 2], np.int32)
    for t in (None, types):
        want = D_ref.build_examples(pos, valid, 0.4, types=t, **kw)
        got = D.build_examples(pos, valid, 0.4, types=t, **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_batches_equal(g, w)


def test_derivative_and_state():
    pos, valid = tracks(1)
    np.testing.assert_array_equal(D.tracks_to_state(pos, valid, 0.25),
                                  D_ref.tracks_to_state(pos, valid, 0.25))
    x = pos[..., 0]
    np.testing.assert_array_equal(D.derivative_of(x, 0.4),
                                  D_ref.derivative_of(x, 0.4))
    np.testing.assert_array_equal(D.derivative_of(x[:, :1], 0.4),
                                  D_ref.derivative_of(x[:, :1], 0.4))


def test_rotate_and_stack():
    pos, valid = tracks(2)
    ex_ref = D_ref.build_examples(pos, valid, 0.4, max_agents=8)
    ex = D.build_examples(pos, valid, 0.4, max_agents=8)
    for theta in (0.3, -2.0):
        assert_batches_equal(D.rotate_scene(ex[3], theta),
                             D_ref.rotate_scene(ex_ref[3], theta))
    # examples without node types stack beside typed ones
    mixed = [ex[0]._replace(node_type=None)] + ex[1:5]
    mixed_ref = [ex_ref[0]._replace(node_type=None)] + ex_ref[1:5]
    assert_batches_equal(D.stack_batches(mixed), D_ref.stack_batches(mixed_ref))
    assert D.NODE_TYPES == D_ref.NODE_TYPES
    assert D.ATTENTION_RADIUS == D_ref.ATTENTION_RADIUS


def test_types_default():
    ex = D.build_examples(*tracks(3), 0.4)[0]._replace(node_type=None)
    np.testing.assert_array_equal(ex.types(), np.zeros(7, np.int32))
    t = ex.to_tensors("cpu")
    assert torch.equal(t.types(), torch.zeros(7, dtype=torch.int32))


def test_to_tensors():
    ex = D.stack_batches(D.build_examples(*tracks(4), 0.4)[:3])
    t = ex.to_tensors("cpu")
    for name, g, w in zip(ex._fields, t, ex):
        assert torch.is_tensor(g), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert t.hist.dtype == torch.float32 and t.agent_mask.dtype == torch.bool
    assert t.node_type.dtype == torch.int32
    assert t.to_tensors("cpu").hist is t.hist


def test_scenes_from_env_rollout():
    """The reference's rollout of the ORCA robot, sliced on both sides."""
    cfg = T_ref.EnvConfig(scenario="circle_crossing", human_policy="orca",
                          human_num=3, max_humans=4, starts_moving=0,
                          robot_kinematics="holonomic")
    state = CS_ref.reset_host(cfg, 2)
    _, _, traj = R_ref.batch_rollout(
        jax.tree.map(lambda x: x[None], state),
        lambda s: OR_ref.orca_robot_action(s, cfg), cfg, max_steps=20)
    scene = jax.tree.map(lambda x: np.asarray(x[0]), traj)
    for human_only in (True, False):
        p_ref, v_ref = D_ref.scenes_from_env_rollout(scene, human_only)
        p, v = D.scenes_from_env_rollout(scene, human_only)
        np.testing.assert_array_equal(p, p_ref)
        np.testing.assert_array_equal(v, v_ref)
        for g, w in zip(D.build_examples(p, v, cfg.dt, stride=4),
                        D_ref.build_examples(p_ref, v_ref, cfg.dt, stride=4)):
            assert_batches_equal(g, w)


def _write_files(tmp_path):
    rng = np.random.default_rng(5)
    eth = tmp_path / "eth.txt"
    rows = []
    for f in range(0, 200, 10):
        for ped in (1, 2, 5):
            if ped == 5 and f < 60:
                continue
            x, y = rng.normal(size=2)
            rows.append(f"{f}\t{ped}\t{x:.3f}\t{y:.3f}")
    eth.write_text("\n".join(rows) + "\n")
    jrdb = tmp_path / "jrdb.csv"
    lines = ["frame_id,track_id,x,y,node_type"]
    for f in range(0, 300, 10):
        for tid, cls in ((1, "PEDESTRIAN"), (2, "BICYCLE"), (3, "ROBOT"),
                         (4, "CAR")):
            x, y = rng.normal(size=2)
            lines.append(f"{f},{tid},{x:.4f},{y:.4f},{cls}")
    jrdb.write_text("\n".join(lines) + "\n")
    hst = tmp_path / "hst.csv"
    lines = ["frame_id,track_id,x,y,interpolated"]
    for f in range(0, 100, 10):
        for tid in (7, 8):
            x, y = rng.normal(size=2)
            lines.append(f"{f},{tid},{x:.4f},{y:.4f},{f % 20 // 10}")
    hst.write_text("\n".join(lines) + "\n")
    return eth, jrdb, hst


def test_loaders(tmp_path):
    eth, jrdb, hst = _write_files(tmp_path)
    for got, want in [
            (D.load_ethucy_txt(str(eth)), D_ref.load_ethucy_txt(str(eth))),
            (D.load_trajectory_file(str(eth), center=False),
             D_ref.load_trajectory_file(str(eth), center=False)),
            (D.load_trajectory_file(str(jrdb)),
             D_ref.load_trajectory_file(str(jrdb))),
            (D.load_trajectory_file(str(jrdb), keep_classes=None,
                                    return_types=True),
             D_ref.load_trajectory_file(str(jrdb), keep_classes=None,
                                        return_types=True)),
            (D.load_trajectory_file(str(hst), return_types=True),
             D_ref.load_trajectory_file(str(hst), return_types=True))]:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    pos, valid = D.load_ethucy_txt(str(eth))
    for g, w in zip(D.build_examples(pos, valid, 0.4, max_agents=16),
                    D_ref.build_examples(*D_ref.load_ethucy_txt(str(eth)),
                                         0.4, max_agents=16)):
        assert_batches_equal(g, w)

"""The port's metrics logging (``sicnav_tpu_torch/utils/metrics.py``)
against the reference's: the same JSONL records, the same episode event
rates, and a clear error for tensorboard files without a writer package."""

import builtins
import json

import numpy as np
import pytest
import torch

from sicnav_tpu.utils import metrics as MET_ref
from sicnav_tpu_torch.env.rollout import EpisodeStats
from sicnav_tpu_torch.utils import metrics as MET


def test_jsonl_stream(tmp_path):
    for mod, d in ((MET, tmp_path / "port"), (MET_ref, tmp_path / "ref")):
        log = mod.MetricsLogger(str(d), "jmid")
        log.log(0, loss=torch.tensor(0.5) if mod is MET else 0.5,
                val_ade=np.float32(0.25), note="x")
        log.log(1, loss=0.125, val_ade=float("inf"))
        log.close()
    got = [json.loads(x) for x in (tmp_path / "port" / "jmid.jsonl")
           .read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "ref" / "jmid.jsonl")
            .read_text().splitlines()]
    for g, w in zip(got, want):
        g.pop("wall_s")
        w.pop("wall_s")
        assert g == w


def test_tensorboard_needs_its_package(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(RuntimeError, match="tensorboard package"):
        MET.MetricsLogger(str(tmp_path), tensorboard=True)


def test_tensorboard_events_where_installed(tmp_path):
    pytest.importorskip("tensorboard")
    log = MET.MetricsLogger(str(tmp_path), tensorboard=True)
    log.log(3, loss=1.5)
    log.close()
    assert any((tmp_path / "tb").iterdir())


def test_episode_event_rates():
    rng = np.random.default_rng(0)
    n = 12
    steps = rng.integers(0, 60, n).astype(np.int32)
    fields = dict(
        success=rng.random(n) < 0.5, timeout=rng.random(n) < 0.2,
        nav_time=rng.uniform(5, 30, n).astype(np.float32),
        collision_steps=rng.integers(0, 3, n).astype(np.int32),
        wall_collision_steps=rng.integers(0, 2, n).astype(np.int32),
        frozen_steps=rng.integers(0, 4, n).astype(np.int32),
        frozen_near_goal_steps=np.zeros(n, np.int32),
        danger_steps=rng.integers(0, 9, n).astype(np.int32),
        yield_steps=np.zeros(n, np.int32),
        frozen_yield_steps=np.zeros(n, np.int32),
        min_dist=rng.uniform(0, 2, n).astype(np.float32),
        total_reward=rng.normal(size=n).astype(np.float32), steps=steps)
    port = EpisodeStats(**{k: torch.as_tensor(v) for k, v in fields.items()})

    class RefStats:   # the reference reads these fields as arrays
        pass

    ref = RefStats()
    for k, v in fields.items():
        setattr(ref, k, v)
    got, want = MET.episode_event_rates(port), MET_ref.episode_event_rates(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k

"""The port's evaluation harness (sicnav_tpu_torch.harness) against the JAX
reference's (sicnav_tpu.harness), and its progress file.

- ``evaluate_policy`` with DWA over 3 host cases of the protocol env at a
  4 s time limit: the summary's rates, which count integer statistics,
  exactly; its means of float statistics (nav time, reward) within 1e-4,
  as tests/test_torch_rollout_batch.py holds the statistics.
- ``summarize`` on the same seeded numpy statistics: 1e-12 (the same numpy
  code on the same arrays; only the summation order may differ).
- The progress file: the reference's JSONL format, read back by both
  sides; a corrupt trailing line is skipped; the port reads each field
  back in its own dtype, so a summary of what it read equals the summary
  of what it wrote, exactly; a rerun resumes without stepping and
  returns the same summary.
"""

import dataclasses
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from sicnav_tpu import harness as H_ref
from sicnav_tpu.env import rollout as RO_ref
from sicnav_tpu.policies import dwa as D_ref
from sicnav_tpu_torch import harness as H
from sicnav_tpu_torch.env import rollout as RO
from sicnav_tpu_torch.policies import dwa as D

from tests.test_torch_env import port_cfg
from tests.test_torch_rollout_batch import SHORT

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
# summary keys that are means of float statistics; the others count
FLOAT_KEYS = {"mean_nav_time", "mean_total_reward"}


def _random_stats(seed, n=40):
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 123, n).astype(np.int32)

    def part():
        return (steps * rng.uniform(0, 1, n)).astype(np.int32)

    frozen = part()
    return RO.EpisodeStats(
        success=rng.uniform(size=n) < 0.8, timeout=rng.uniform(size=n) < 0.1,
        nav_time=rng.uniform(5, 30, n).astype(np.float32),
        collision_steps=part() * (rng.uniform(size=n) < 0.2),
        wall_collision_steps=part() * (rng.uniform(size=n) < 0.1),
        frozen_steps=frozen, frozen_near_goal_steps=frozen // 2,
        danger_steps=part(), yield_steps=part(),
        frozen_yield_steps=frozen // 3,
        min_dist=rng.uniform(0, 2, n).astype(np.float32),
        total_reward=rng.normal(0, 1, n).astype(np.float32), steps=steps)


@pytest.mark.parametrize("seed", [0, 1])
def test_summarize_matches_reference(seed):
    stats = _random_stats(seed)
    got = H.summarize(stats, port_cfg(SHORT))
    want = H_ref.summarize(RO_ref.EpisodeStats(*stats), SHORT)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_evaluate_policy_dwa_matches_reference():
    cfg = port_cfg(SHORT)
    want = H_ref.evaluate_policy(lambda s: D_ref.dwa_policy(s, SHORT), SHORT,
                                 num_cases=3, batch=3)
    got = H.evaluate_policy(lambda s: D.dwa_policy_batch(s, cfg), cfg,
                            num_cases=3, batch=3, device="cpu")
    assert got.keys() == want.keys() and got["num_cases"] == 3
    for k in want:
        tol = 1e-4 if k in FLOAT_KEYS else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_progress_file_round_trip_and_corrupt_line(tmp_path):
    """Both sides read what the port writes; a line cut mid-write (a worker
    killed) and a line of another shape are skipped."""
    path = str(tmp_path / "progress.jsonl")
    a, b = _random_stats(2, n=4), _random_stats(3, n=2)
    H._append_progress(path, 0, a)
    H._append_progress(path, 4, b)
    with open(path, "a") as f:
        f.write('{"start": 6, "stats": {"success": [true, fal')
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 3
    for load in (H._load_progress, H_ref._load_progress):
        done = load(path)
        assert sorted(done) == [0, 4]
        for start, want in ((0, a), (4, b)):
            for name, x, y in zip(RO.EpisodeStats._fields, done[start], want):
                np.testing.assert_array_equal(x, y, err_msg=name)
    done = H._load_progress(path)
    for start, want in ((0, a), (4, b)):
        for name, x, y in zip(RO.EpisodeStats._fields, done[start], want):
            assert x.dtype == y.dtype, name
    cfg = port_cfg(SHORT)
    assert H.summarize(H._concat(done[0], done[4]), cfg) == \
        H.summarize(H._concat(a, b), cfg)
    with open(path, "a") as f:
        f.write("\n" + json.dumps({"start": 8, "stats": {"nope": [1]}}) + "\n")
    assert sorted(H._load_progress(path)) == [0, 4]
    assert H._load_progress(str(tmp_path / "missing.jsonl")) == {}


def test_evaluate_policy_resumes_without_stepping(tmp_path, monkeypatch):
    """A rerun with the same progress file skips every batch it holds
    (4 cases in batches of 3 and 1) and returns the same summary; a batch
    recorded with another size is stepped again."""
    cfg = port_cfg(dataclasses.replace(SHORT, time_limit=1.0))
    path = str(tmp_path / "progress.jsonl")

    def policy(states):
        return D.dwa_policy_batch(states, cfg)

    first = H.evaluate_policy(policy, cfg, num_cases=4, batch=3,
                              progress_file=path, device="cpu")
    with open(path, "a") as f:
        f.write('{"start": 4, "stats": {"succ')     # killed mid-write

    def no_stepping(*args, **kwargs):
        raise AssertionError("a completed batch was stepped again")

    monkeypatch.setattr(RO, "batch_rollout", no_stepping)
    assert H.evaluate_policy(policy, cfg, num_cases=4, batch=3,
                             progress_file=path, device="cpu") == first
    with pytest.raises(AssertionError, match="stepped again"):
        H.evaluate_policy(policy, cfg, num_cases=4, batch=2,
                          progress_file=path, device="cpu")


def test_chip_smoke_harness_rehearsal(tmp_path):
    """chip_smoke.py's harness phase, run for two cases on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    res = chip_smoke.phase_harness(device="cpu", n_cases=2,
                                   progress_file=str(tmp_path / "p.jsonl"))
    assert res["num_cases"] == 2


def test_eval_suite_script_dwa(tmp_path, capsys):
    """scripts/eval_suite_torch.py prints the summary as one JSON line and
    resumes from its progress file."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import eval_suite_torch

    argv = ["--policy", "dwa", "--num_cases", "2", "--batch", "2",
            "--time_limit", "1", "--device", "cpu", "--progress_file",
            str(tmp_path / "p.jsonl")]
    for _ in range(2):
        assert eval_suite_torch.main(argv) == 0
        out = capsys.readouterr().out.strip().splitlines()
        res = json.loads(out[-1])
        assert res["num_cases"] == 2 and res["timeout_rate"] == 1.0
    with pytest.raises(SystemExit):
        eval_suite_torch.parse_args(["--policy", "dwa", "--traced", "x.npz"])
    assert os.path.exists(tmp_path / "p.jsonl")

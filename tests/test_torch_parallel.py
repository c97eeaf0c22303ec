"""The port's data-parallel mesh (sicnav_tpu_torch.parallel), the twins of
tests/test_parallel.py, on 2 CPU ranks over gloo.

The reference's invariant is kept: a run over an N-rank mesh gives what
the same call gives without one. One launch of 2 ranks runs every sharded
stage (``parallel/dryrun.run_stages``); each test holds one stage to the
same stage on a one-rank mesh in this process, on one thread as each CPU
rank runs:

- the mesh: its size, backend and rank devices; the one-rank mesh outside
  a world; rows that do not divide raise;
- the env + DWA step over 4 states: positions and mean reward 1e-6;
- ``harness.evaluate_policy(mesh=)`` of DWA over 3 cases (padded to 4):
  every summary metric 1e-6;
- the fleet CAMPC step over 4 resets: actions 1e-5;
- the replicated-parameter DP SARL train step against the one-rank step,
  and that step against the reference's ``RD.train_step`` on the same
  batch from converted parameters: loss 1e-5, parameters 5e-5;
- ``dqn.train(mesh=)`` against ``dqn.train()`` over 128 steps, 16
  environments, batch 32: parameters 5e-5;
- ``scripts/train_rl_torch.py --mesh 2`` against the same run without a
  mesh: the checkpoints 5e-5;
- ``launch`` raises with a failing rank's traceback and at its deadline.

SARL's last attention bias shifts every score alike, so the softmax
cancels its gradient and Adam steps it by up to lr on rounding's sign
(tests/test_torch_rl_dqn.py): it is held within 3 lr a step of its start
on both sides instead.
"""

import contextlib
import dataclasses
import json
import multiprocessing
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sicnav_tpu.rl import dqn as RD
from sicnav_tpu.rl import networks as RN
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.parallel import dryrun as DR
from sicnav_tpu_torch.parallel import mesh as M
from sicnav_tpu_torch.rl.networks import SARLNetwork

from tests.test_torch_rl_networks import SOFTMAX_SHIFTS, ref_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
LR = 1e-3
PORT_SOFTMAX_SHIFT = "attention.layers.2.bias"
DQN_TRAIN_STEPS = 6          # steps 48, 64, ..., 128 of 16 environments


def _sarl_inputs():
    """The reference test's DP step: seed-0 SARL parameters, a batch of 16
    normal transitions, every human present, none done."""
    B, H = 16, 3
    rng = np.random.default_rng(1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    batch = RD.Transition(f(B, 9), f(B, H, 5), np.ones((B, H), bool),
                          f(B, 9), f(B, H, 5), f(B), np.zeros(B, bool))
    return ref_params("sarl", seed=0, H=H), batch


SARL_PARAMS, SARL_BATCH = _sarl_inputs()
SARL_SD = convert.sarl_state_dict(jax.tree.map(np.asarray, SARL_PARAMS))
STAGES = [
    ("layout", {}),
    ("env_dwa", dict(batch_size=4)),
    ("harness_dwa", dict(num_cases=3, batch=3, time_limit=8.0)),
    ("fleet_actions", dict(batch_size=4)),
    ("sarl_train", dict(params=SARL_SD, target=SARL_SD, batch=SARL_BATCH,
                        lr=LR)),
    ("dqn_train", {}),
]


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sharded():
    return M.launch(DR.run_stages, RANKS, STAGES, device="cpu", timeout=600)


@pytest.fixture(scope="module")
def single():
    with one_thread():
        return DR.run_stages(M.make_mesh(device="cpu"), STAGES)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _params_close(got, want, start, steps, tol=5e-5):
    assert set(got) == set(want)
    for k in want:
        if k == PORT_SOFTMAX_SHIFT:
            for side in (got[k], want[k]):
                assert (side - start[k]).abs().max() <= 3 * steps * LR, k
            continue
        _close(got[k], want[k], tol)


def test_mesh_layout(sharded):
    assert sharded["layout"] == {"size": RANKS, "backend": "gloo",
                                 "devices": ["cpu"] * RANKS}
    one = M.make_mesh(device="cpu")
    assert (one.rank, one.size, one.backend) == (0, 1, "none")
    assert M.plan(RANKS, "cpu") == ("gloo", [torch.device("cpu")] * RANKS)
    with pytest.raises(ValueError, match="outside"):
        M.make_mesh(RANKS, device="cpu")
    mesh = dataclasses.replace(one, rank=1, size=2)
    assert mesh.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="divide"):
        mesh.rows(3)


def test_env_dwa_step_sharded_matches_unsharded(sharded, single):
    got, want = sharded["env_dwa"], single["env_dwa"]
    assert got["r_pos"].shape == (4, 2)
    _close(got["r_pos"], want["r_pos"], 1e-6)
    _close(got["mean_reward"], want["mean_reward"], 1e-6)


def test_harness_sharded_matches_unsharded(sharded, single):
    """3 cases over 2 ranks: the batch is padded with case 2 again, and
    the padding is sliced out of the stats."""
    got, want = sharded["harness_dwa"], single["harness_dwa"]
    assert got["num_cases"] == 3 and set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-6)


def test_fleet_step_sharded_matches_unsharded(sharded, single):
    got, want = sharded["fleet_actions"], single["fleet_actions"]
    assert got["actions"].shape == (4, 2)
    assert torch.isfinite(got["actions"]).all()
    _close(got["actions"], want["actions"], 1e-5)


def test_dp_sarl_train_step(sharded, single):
    """Sharded against one rank, and one rank against the reference's step
    on the same batch from the same parameters."""
    got, want = sharded["sarl_train"], single["sarl_train"]
    _close(got["loss"], want["loss"], 1e-5)
    _params_close(got["params"], want["params"], SARL_SD, 1)

    tx = optax.adam(LR)
    params, _, loss = RD.train_step(
        RN.SARLNetwork(), tx, SARL_PARAMS, SARL_PARAMS, tx.init(SARL_PARAMS),
        RD.Transition(*map(jnp.asarray, SARL_BATCH)), 0.9)
    _close(want["loss"], float(loss), 1e-5)
    ref = convert.sarl_state_dict(jax.tree.map(np.asarray, params))
    _params_close(want["params"], ref, SARL_SD, 1)
    assert PORT_SOFTMAX_SHIFT in ref and len(SOFTMAX_SHIFTS) == 1


def test_dqn_train_sharded_matches_unsharded(sharded, single):
    got, want = sharded["dqn_train"], single["dqn_train"]
    init = SARLNetwork(device="cpu").state_dict()      # the stage's start
    _params_close(got["params"], want["params"], init, DQN_TRAIN_STEPS)
    assert got["history"] == want["history"]


def test_train_rl_script_mesh(tmp_path, capsys):
    """--mesh 2 trains the DQN in two ranks of the script's own; rank 0's
    checkpoint is the one-process run's."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_rl_torch

    argv = ["--device", "cpu", "--il_episodes", "4", "--il_epochs", "1",
            "--total_timesteps", "1040", "--n_envs", "8", "--log_every",
            "65"]
    lines = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2"])):
        with one_thread():
            assert train_rl_torch.main(
                argv + extra + ["--out", str(tmp_path / f"{name}.npz")]) == 0
        lines[name] = [json.loads(x) for x in
                       capsys.readouterr().out.strip().splitlines()]
    # the imitation fit (the same in both), one history record, the path
    assert len(lines["mesh"]) == len(lines["one"]) == 3
    assert lines["mesh"][0] == lines["one"][0]
    rec, want_rec = lines["mesh"][1], lines["one"][1]
    assert rec.keys() == want_rec.keys() and rec["step"] == 1040
    for k in want_rec:
        _close(rec[k], want_rec[k], 1e-5)
    got, want = (convert.load_npz(tmp_path / f"{n}.npz")
                 for n in ("mesh", "one"))
    for k in want:
        _close(got[k], want[k], 5e-5)


def test_launch_reports_a_failing_rank():
    # 3 states do not divide over 2 ranks
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"
                       "(.|\n)*does not divide"):
        M.launch(DR.run_stages, RANKS, [("env_dwa", dict(batch_size=3))],
                 device="cpu", timeout=120)
    with pytest.raises(RuntimeError, match="did not report within"):
        M.launch(DR.run_stages, RANKS, [("layout", {})], device="cpu",
                 timeout=0.5)
    assert not multiprocessing.active_children()

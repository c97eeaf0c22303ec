"""The port's analysis scripts against the reference's.

- Options: every ``scripts/*_torch.py`` twin of this slice takes every
  option of its reference with the same default, choices, type and
  nargs; the only additions are the port-only ``--device`` (and
  eval_dispatch_paired's checkpoints default to ``.npz`` paths).
- bench_control_step_torch at 1 call a row and 2 IPM iterations on the
  CPU: every key of the reference's JSON, and ``kkt_dim`` equal to the
  reference's fused OCP's n_z + n_eq for the same flags (the reference's
  OCP is built, nothing is compiled).
- sweep_ipm_iters_torch: with the suite and the latency stubbed, the same
  frontier rows as the reference's script; the latency of one step at 2
  iterations on the CPU; one real ``run_suite`` subprocess of
  eval_suite_torch.py (DWA) with ``--device`` passed through.
- summarize_progress_torch and the reference's script on a progress file
  the port's harness wrote (DWA, 4 cases, batch 2): equal JSON.
- eval_dispatch_paired_torch: its statistics and the reference's on the
  same per-agent arrays (equal JSON), and its validation split equal to
  the one train_jmid_torch.py trains against.
- eval_sicnav_diffusion_torch: one case of 2 steps at 2 IPM iterations
  on the CPU gives the reference's summary keys.
"""

import argparse
import contextlib
import io
import json
import math
import pathlib
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sicnav_tpu.diffusion.mid as MID_ref
import sicnav_tpu.mpc.sicnav_diffusion as SD_ref
import sicnav_tpu_torch.diffusion.mid as MID
from sicnav_tpu.diffusion import data as D_ref
from sicnav_tpu.env.types import EnvConfig as EnvConfig_ref
from sicnav_tpu.mpc import ipm as ipm_ref
from sicnav_tpu_torch.diffusion import data as D

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import bench_control_step as BC_ref  # noqa: E402
import bench_control_step_torch as BC  # noqa: E402
import collision_taxonomy as CT_ref  # noqa: E402
import collision_taxonomy_torch as CT  # noqa: E402
import eval_dispatch_paired as EDP_ref  # noqa: E402
import eval_dispatch_paired_torch as EDP  # noqa: E402
import eval_sicnav_diffusion as ESD_ref  # noqa: E402
import eval_sicnav_diffusion_torch as ESD  # noqa: E402
import eval_suite_torch as ES  # noqa: E402
import simple_test as ST_ref  # noqa: E402
import simple_test_torch as ST  # noqa: E402
import suite_audit as SA_ref  # noqa: E402
import suite_audit_torch as SA  # noqa: E402
import summarize_progress as SP_ref  # noqa: E402
import summarize_progress_torch as SP  # noqa: E402
import sweep_ipm_iters as SW_ref  # noqa: E402
import sweep_ipm_iters_torch as SW  # noqa: E402
import timeout_taxonomy as TT_ref  # noqa: E402
import timeout_taxonomy_torch as TT  # noqa: E402
import train_jmid as TJ_ref  # noqa: E402
import train_jmid_torch as TJ  # noqa: E402

PAIRS = {
    "simple_test": (ST_ref, ST),
    "eval_sicnav_diffusion": (ESD_ref, ESD),
    "bench_control_step": (BC_ref, BC),
    "collision_taxonomy": (CT_ref, CT),
    "timeout_taxonomy": (TT_ref, TT),
    "suite_audit": (SA_ref, SA),
    "sweep_ipm_iters": (SW_ref, SW),
    "summarize_progress": (SP_ref, SP),
    "eval_dispatch_paired": (EDP_ref, EDP),
}
PORT_DEFAULTS = {"eval_dispatch_paired": {"ckpt_dispatch",
                                          "ckpt_no_dispatch"}}


class _Parser(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(fn, monkeypatch, argv=None):
    """The ArgumentParser that ``fn`` builds, caught as it parses."""
    def caught(self, args=None, namespace=None):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", caught)
        m.setattr(sys, "argv", ["x"])
        with pytest.raises(_Parser) as e:
            fn() if argv is None else fn(argv)
    return e.value.parser


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", list(PAIRS))
def test_options_match_reference(name, monkeypatch):
    ref_mod, port_mod = PAIRS[name]
    ref = _actions(_parser(ref_mod.main, monkeypatch))
    port = _actions(_parser(port_mod.main, monkeypatch, []))
    assert set(port) - set(ref) == {"device"} or name == \
        "summarize_progress" and set(port) == set(ref)
    assert set(ref) <= set(port)
    for dest, a in ref.items():
        b = port[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.choices, b.nargs, b.type, b.const) == \
            (a.choices, a.nargs, a.type, a.const), dest
        if dest not in PORT_DEFAULTS.get(name, ()):
            assert b.default == a.default, (dest, b.default, a.default)
    if "device" in port:
        assert port["device"].default is None


def test_bench_control_step_rows():
    args = BC.parse_args(["--ipm_iters", "2", "--device", "cpu"])
    out, ocp = BC.measure(args, torch.device("cpu"), reps=1)
    assert set(out) == {"forecast_ms", "campc_solve_ms", "fused_step_ms",
                        "kkt_solve_1x_ms", "kkt_solve_16x_ms", "kkt_dim",
                        "ipm_iters", "per_iter_solve_share_ms"}
    for k, v in out.items():
        assert math.isfinite(v) and v > 0, k
    ocp_ref, _ = SD_ref.make_policy(
        EnvConfig_ref(scenario="hallway_bottleneck", human_policy="orca_plus",
                      human_num=3, max_humans=3,
                      robot_kinematics="unicycle"), None, None,
        settings=ipm_ref.IPMSettings(n_iter=2))
    assert out["kkt_dim"] == ocp_ref.cfg.n_z + ocp_ref.n_eq == \
        ocp.cfg.n_z + ocp.n_eq == 317
    assert out["per_iter_solve_share_ms"] == 2 * out["kkt_solve_1x_ms"]


def _suite_result(iters, args, extra=(), early_exit=0.0):
    f = iters / 100 + early_exit
    return {"success_rate": 0.5 + f, "collision_episode_rate": 0.1 + f,
            "wall_collision_episode_rate": 0.05, "frozen_episode_rate": f,
            "mean_nav_time": 20.0 - iters, "mean_total_reward": -f}


def _latency(iters, args, n_steps=30, early_exit=0.0):
    return 100.0 * iters + early_exit


def test_sweep_rows_match_reference(monkeypatch, capsys):
    argv = ["--iters", "2", "5", "--early_exit", "1e-4", "1e-3",
            "--num_cases", "3"]
    for mod in (SW, SW_ref):
        monkeypatch.setattr(mod, "run_suite", _suite_result)
        monkeypatch.setattr(mod, "measure_latency", _latency)
    monkeypatch.setattr(sys, "argv", ["sweep_ipm_iters.py", *argv])
    SW_ref.main()
    want = json.loads(capsys.readouterr().out)
    rows = SW.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["frontier"] == want["frontier"] == rows
    assert len(rows) == 4 and all("latency_p50_ms" in r for r in rows)
    assert {k: v for k, v in got["config"].items() if k != "device"} == \
        want["config"]


def test_sweep_latency_and_suite_subprocess(monkeypatch):
    import eval_suite as ES_ref
    args = SimpleNamespace(policy="dwa", scenario="hallway_bottleneck",
                           num_cases=2, batch=2, num_humans=3,
                           privileged=False, checkpoint=None, device="cpu")
    ms = SW.measure_latency(2, args, n_steps=1)
    assert math.isfinite(ms) and ms > 0
    res = SW.run_suite(5, args)
    assert res["num_cases"] == 2 and 0.0 <= res["success_rate"] <= 1.0
    # the suite the reference's sweep runs: eval_suite.py's time limit
    ref = _actions(_parser(ES_ref.main, monkeypatch))
    assert SW.SUITE_TIME_LIMIT == ref["time_limit"].default


def test_summarize_progress_matches_reference(tmp_path, monkeypatch,
                                              capsys):
    path = str(tmp_path / "progress.jsonl")
    ES.main(["--policy", "dwa", "--num_cases", "4", "--batch", "2",
             "--progress_file", path, "--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["summarize_progress.py", path])
    SP_ref.main()
    want = capsys.readouterr().out
    got = SP.main([path])
    assert capsys.readouterr().out == want
    assert json.loads(want) == got and got["num_cases"] == 4
    assert got["batches"] == [0, 2]


def _typed_examples(n, rng, cls):
    """n scenes of 3 agents whose hist[0, 0, 0] is the scene's index."""
    out = []
    for i in range(n):
        hist = rng.normal(size=(3, 6, 6)).astype(np.float32)
        hist[0, 0, 0] = i
        out.append(cls(hist=hist, hist_mask=np.ones((3, 6), bool),
                       fut_vel=np.zeros((3, 8, 2), np.float32),
                       fut_mask=np.ones((3, 8), bool),
                       agent_mask=np.ones(3, bool),
                       neighbor_mask=np.ones((3, 3), bool),
                       node_type=np.array([0, 1, 2], np.int32)[
                           rng.permutation(3)]))
    return out


def test_dispatch_statistics_match_reference(monkeypatch, capsys):
    """Both scripts on the same scenes with eval_scene_per_agent stubbed by
    the same per-agent arrays (scene i, model d or n): equal JSON."""
    n = 100
    rng = np.random.default_rng(0)
    per = {(i, m): (rng.uniform(0.1, 1.0, 3).astype(np.float32),
                    rng.uniform(0.1, 2.0, 3).astype(np.float32),
                    rng.random(3) < 0.9)
           for i in range(n) for m in "dn"}
    ref_ex = _typed_examples(n, np.random.default_rng(1), D_ref.SceneBatch)
    port_ex = _typed_examples(n, np.random.default_rng(1), D.SceneBatch)

    class StubRef:
        def __init__(self, cfg, joint=True):
            self.tag = "d" if cfg.num_node_types == 3 else "n"

        def init(self, *a, **kw):
            return {}

    def ref_eval(model, params, ex, key, n_samples):
        a, f, ok = per[(int(ex.hist[0, 0, 0]), model.tag)]
        return jnp.asarray(a), jnp.asarray(f), jnp.asarray(ok)

    monkeypatch.setattr(TJ_ref, "generate_sim_scenes",
                        lambda *a, **kw: list(ref_ex))
    monkeypatch.setattr(MID_ref, "JMIDModel", StubRef)
    monkeypatch.setattr(MID_ref, "load_checkpoint", lambda path, p: p)
    monkeypatch.setattr(MID_ref, "eval_scene_per_agent", ref_eval)
    monkeypatch.setattr(sys, "argv", ["eval_dispatch_paired.py",
                                      "--n_scenes", "600"])
    EDP_ref.main()
    want = json.loads(capsys.readouterr().out)

    def port_eval(model, batch, n_samples, generator=None, x_T=None,
                  stride=2):
        assert x_T is not None
        a, f, ok = per[(int(batch.hist[0, 0, 0]), model.tag)]
        return torch.as_tensor(a), torch.as_tensor(f), torch.as_tensor(ok)

    class StubPort:
        def __init__(self, tag):
            self.tag, self.cfg = tag, SimpleNamespace(horizon=8)

    monkeypatch.setattr(TJ, "generate_sim_scenes",
                        lambda *a, **kw: list(port_ex))
    monkeypatch.setattr(EDP, "load_model", lambda nnt, path, device:
                        StubPort("d" if nnt == 3 else "n"))
    monkeypatch.setattr(MID, "eval_scene_per_agent", port_eval)
    got = EDP.main(["--n_scenes", "600", "--device", "cpu"])
    capsys.readouterr()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["ALL"]["n"] > 0


def test_dispatch_split_is_train_jmid_split(tmp_path, monkeypatch):
    argv = ["--multi_class", "--class_mode", "maneuver", "--n_scenes", "8",
            "--seed", "3", "--device", "cpu", "--encoder_dim", "16",
            "--tf_layer", "1", "--batch_size", "4", "--epochs", "1",
            "--out", str(tmp_path / "m.npz")]
    seen = {}

    class _Stop(Exception):
        pass

    def fit(model, train_batches, val_batches, tc, **kw):
        seen["val"] = val_batches
        raise _Stop

    monkeypatch.setattr(MID, "fit", fit)
    with pytest.raises(_Stop):
        TJ.main(argv)
    args = EDP.parse_args(["--n_scenes", "8", "--seed", "3",
                           "--class_mode", "maneuver", "--device", "cpu"])
    val = EDP.val_split(args, torch.device("cpu"))
    mine = TJ.batches(val, 4)
    assert len(mine) == len(seen["val"]) > 0
    for a, b in zip(mine, seen["val"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_eval_sicnav_diffusion_runs():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = ESD.main(["--num_cases", "1", "--ipm_iters", "2",
                        "--device", "cpu"], max_steps=2)
    assert set(out) == {"num_cases", "success_rate", "mean_nav_time",
                        "collision_steps", "control_step_ms_p50",
                        "control_step_ms_p95"}
    assert out["num_cases"] == 1 and out["control_step_ms_p50"] > 0

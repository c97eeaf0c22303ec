"""The port's episode audits (scripts/{audit_common,collision_taxonomy,
timeout_taxonomy,suite_audit}_torch.py) against the reference's.

- ``collision_report`` and ``timeout_report`` of both packages on the same
  synthetic traced suite, built to hit every collision class and every
  timeout class: the JSON reports are equal.
- ``build``: the MPCConfig, IPMSettings and EnvConfig the port builds for
  each policy and flag combination equal the reference's, field for field
  (the reference's captured at its OCP, without compiling anything).
- ``run_traced_suite`` with a stub controller step (no MPC): the
  ``--resume_dir`` batch files round-trip; a batch file the port wrote
  loads through the reference's runner, and one the reference wrote (its
  traced rollout stubbed with the same arrays) loads through the port's;
  both packages' files hold the same keys and arrays.
- ``suite_audit_torch.main`` end to end on the CPU with that stub.
"""

import argparse
import dataclasses
import json
import pathlib
import sys
from types import SimpleNamespace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sicnav_tpu.diffusion.mid as MID_ref
import sicnav_tpu.env.rollout as RO_ref
import sicnav_tpu.env.types as T_ref
import sicnav_tpu.mpc.ocp as OCP_ref
import sicnav_tpu_torch.mpc.campc as C
import sicnav_tpu_torch.mpc.sicnav_diffusion as SD
from sicnav_tpu.env.types import EnvConfig as EnvConfig_ref
from sicnav_tpu_torch import harness
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import rollout as RO
from sicnav_tpu_torch.env.types import EnvConfig

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import audit_common as AC_ref  # noqa: E402
import audit_common_torch as AC  # noqa: E402
import collision_taxonomy as CT_ref  # noqa: E402
import collision_taxonomy_torch as CT  # noqa: E402
import suite_audit_torch as SA  # noqa: E402
import timeout_taxonomy as TT_ref  # noqa: E402
import timeout_taxonomy_torch as TT  # noqa: E402

T, H = 8, 3


class Aux(NamedTuple):
    use_guess: object
    sol_feasible: object
    sol_realistic: object
    cost_worse: object
    braked: object
    rescued: object
    slack_max: object
    exact_margin: object


def _env(cls=EnvConfig, **kw):
    return cls(scenario="hallway_bottleneck", human_policy="orca_plus",
               human_num=H, max_humans=H, starts_moving=0,
               robot_kinematics="unicycle", **kw)


def _synthetic_suite():
    """(stats fields, trace dict): episodes 0-7 collide at step 4, one per
    collision class in classify_episode's order; episodes 8-12 time out,
    one per timeout class (the robot's path set against each case's reset
    geometry); 6 and 9 also hit a wall; frozen steps and adopted-guess runs
    throughout."""
    rng = np.random.default_rng(0)
    B = 13
    cfg = _env()
    resets = [CS.reset_host(cfg, b, "test", device="cpu") for b in range(B)]
    r_dir = [float(np.sign(float(s.r_goal[1] - s.r_pos[1]))) or 1.0
             for s in resets]
    z = np.zeros((B, T), bool)
    aux = {"use_guess": z.copy(), "sol_feasible": ~z, "sol_realistic": ~z,
           "cost_worse": z.copy(), "braked": z.copy(), "rescued": z.copy(),
           "slack_max": rng.uniform(0, 1e-2, (B, T)).astype(np.float32),
           "exact_margin": rng.uniform(0.05, 0.3, (B, T)).astype(np.float32)}
    tr = {"collision": z.copy(), "wall_collision": z.copy(),
          "frozen": rng.random((B, T)) < 0.3, "live": ~z,
          "dmin": rng.uniform(0.1, 2.0, (B, T)).astype(np.float32),
          "action": rng.normal(size=(B, T, 2)).astype(np.float32),
          "latch": rng.random((B, T)) < 0.3,
          "door_stall": rng.integers(-3, 4, (B, T)).astype(np.int32),
          "r_pos": np.zeros((B, T, 2), np.float32),
          "h_pos": np.zeros((B, T, H, 2), np.float32)}
    aux["use_guess"] |= rng.random((B, T)) < 0.2
    tr["collision"][:8, 4] = True
    tr["wall_collision"][[6, 9], 5] = True
    for b in range(8):
        aux["use_guess"][b, 2:5] = False
    aux["braked"][0, 3] = True
    aux["rescued"][1, 4] = True
    for b, field in ((2, "sol_feasible"), (3, "sol_realistic")):
        aux["use_guess"][b, 4] = True
        aux[field][b, 4] = False
    aux["use_guess"][4:6, 3] = True
    aux["cost_worse"][4, 3] = True
    aux["exact_margin"][6, 4] = -0.02
    # the timeout episodes: the robot's progress along its goal's y
    # direction from -2 m, and the humans' end positions
    ends = {8: None, 9: 1.0, 10: 0.0, 11: -1.0, 12: -1.0}   # per class
    for b, end in ends.items():
        prog = (np.full(T, -2.0) if end is None
                else np.linspace(-2.0, end, T))
        tr["r_pos"][b, :, 1] = prog * r_dir[b]
        # 11: a human in the door (a blocker); 12: every human far beyond
        tr["h_pos"][b, :, :, 1] = (0.0 if b == 11 else 2.0 * r_dir[b])
    tr["live"][12, 6:] = False
    steps = tr["live"].sum(1).astype(np.int32)
    timeout = np.zeros(B, bool)
    timeout[8:] = True
    stats = dict(
        success=np.zeros(B, bool), timeout=timeout,
        nav_time=np.full(B, 2.0, np.float32),
        collision_steps=tr["collision"].sum(1).astype(np.int32),
        wall_collision_steps=tr["wall_collision"].sum(1).astype(np.int32),
        frozen_steps=tr["frozen"].sum(1).astype(np.int32),
        frozen_near_goal_steps=np.zeros(B, np.int32),
        danger_steps=np.zeros(B, np.int32), yield_steps=np.zeros(B, np.int32),
        frozen_yield_steps=np.zeros(B, np.int32),
        min_dist=tr["dmin"].min(1), total_reward=np.zeros(B, np.float32),
        steps=steps)
    tr["aux"] = aux
    return stats, tr


def test_taxonomies_equal_reference():
    stats, tr = _synthetic_suite()
    args = SimpleNamespace(num_cases=len(stats["success"]), phase="test")
    port_stats = RO.EpisodeStats(**stats)
    ref_stats = RO_ref.EpisodeStats(**stats)
    got = {**CT.collision_report(port_stats, tr, args, _env()),
           **TT.timeout_report(port_stats, tr, args, _env())}
    want = {**CT_ref.collision_report(ref_stats, tr, args,
                                      _env(EnvConfig_ref)),
            **TT_ref.timeout_report(ref_stats, tr, args,
                                    _env(EnvConfig_ref))}
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert list(got["collision_classes"]) == list(CT.COLLISION_CLASSES)
    assert sorted(got["timeout_classes"]) == sorted(TT.TIMEOUT_CLASSES)
    assert got["wall_classes"] and got["guess_streak_hist"]


BUILDS = {
    "campc": ["--policy", "campc"],
    "cvmm_tro": ["--policy", "campc_cvmm", "--no-ral", "--soc"],
    "privileged": ["--policy", "campc", "--privileged", "--stage_margin",
                   "0.02", "--wall_margin", "0.08", "--time_limit", "30"],
    "mpc_kw": ["--policy", "campc", "--no-brake_on_unreal_guess",
               "--mpc_kw", "door_yield=True,accept_margin=0.02",
               "--ipm_iters", "12"],
    "fused": ["--policy", "sicnav_diffusion", "--time_limit", "30"],
    "fused_tro": ["--policy", "sicnav_diffusion", "--no-ral", "--mpc_kw",
                  "door_yield=False,priviledged_info=False",
                  "--scenario", "circle_crossing"],
}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", list(BUILDS))
def test_build_matches_reference(name, monkeypatch):
    argv = BUILDS[name]
    ref_args = AC_ref.add_policy_args(argparse.ArgumentParser()).parse_args(
        argv)
    captured = {}

    def ref_ocp(cfg):
        captured["mpc"] = cfg
        raise _Stop

    class StubModel:
        def __init__(self, *a, **kw):
            pass

        def init(self, *a, **kw):
            return {}

    def ref_env(*a, **kw):
        captured["env"] = EnvConfig_ref(*a, **kw)
        return captured["env"]

    monkeypatch.setattr(OCP_ref, "OCP", ref_ocp)
    monkeypatch.setattr(MID_ref, "JMIDModel", StubModel)
    monkeypatch.setattr(T_ref, "EnvConfig", ref_env)
    with pytest.raises(_Stop):
        AC_ref.build(ref_args)

    args = AC.add_policy_args(argparse.ArgumentParser()).parse_args(argv)
    built = {}

    def recording(module, name_):
        orig = getattr(module, name_)

        def make(env_cfg, *a, **kw):
            built["env"] = env_cfg
            built["mpc"] = kw.get("mpc_cfg", a[0] if a else None)
            built["settings"] = kw["settings"]
            return orig(env_cfg, *a, **kw)
        monkeypatch.setattr(module, name_, make)

    recording(C, "make_policy")
    recording(SD, "make_policy")
    env_cfg, step_fn, init_carry, max_steps = AC.build(args, "cpu")
    assert built["env"] is env_cfg
    want = dataclasses.asdict(captured["mpc"])
    got = dataclasses.asdict(built["mpc"])
    assert {k: got[k] for k in want} == want
    assert dataclasses.asdict(env_cfg) == dataclasses.asdict(captured["env"])
    assert (built["settings"].n_iter, built["settings"].soc) == \
        (args.ipm_iters, args.soc)
    assert max_steps == int(env_cfg.time_limit / env_cfg.dt) + 2
    assert callable(step_fn) and callable(init_carry)


class StubCarry(NamedTuple):
    door_latch: torch.Tensor
    door_stall: torch.Tensor


def _stub_policy(device="cpu"):
    """A batched step with the CAMPC step's outputs and no MPC: walk
    towards +y at 0.3 m/s; the aux flags are functions of the step."""
    def init_carry(cases):
        n = len(cases)
        return StubCarry(torch.zeros(n, dtype=torch.bool),
                         torch.zeros(n, dtype=torch.int32))

    def step_fn(states, carry):
        k = states.step_idx.to(torch.float32)
        odd = (states.step_idx % 2) == 1
        aux = C.CAMPCAux(
            use_guess=odd, sol_feasible=~odd, sol_realistic=torch.ones_like(
                odd), cost_worse=torch.zeros_like(odd), braked=k > 3,
            rescued=torch.zeros_like(odd), slack_max=k * 1e-3,
            exact_margin=0.1 - 0.02 * k, ineq_viol=k * 0,
            eq_viol=k * 0)
        actions = torch.stack([torch.full_like(k, 0.3),
                               torch.zeros_like(k)], -1)
        carry = StubCarry(odd, carry.door_stall + 1)
        return actions, carry, aux

    return init_carry, step_fn


def _suite_args(resume_dir, num_cases=3, batch=1):
    return SimpleNamespace(num_cases=num_cases, batch=batch, phase="test",
                           resume_dir=str(resume_dir))


def _assert_same(a, b):
    stats_a, tr_a = a
    stats_b, tr_b = b
    for x, y in zip(stats_a, stats_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert set(tr_a) == set(tr_b) and set(tr_a["aux"]) == set(tr_b["aux"])
    for k in tr_a:
        if k != "aux":
            np.testing.assert_array_equal(tr_a[k], tr_b[k], err_msg=k)
    for k in tr_a["aux"]:
        np.testing.assert_array_equal(tr_a["aux"][k], tr_b["aux"][k],
                                      err_msg=k)


def _refuse(*a, **kw):
    raise AssertionError("a resumed suite must not step")


def test_resume_files_cross_load(tmp_path, monkeypatch):
    env_cfg = _env(time_limit=1.0)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    init_carry, step_fn = _stub_policy()
    port_dir = tmp_path / "port"
    first = AC.run_traced_suite(_suite_args(port_dir), env_cfg, step_fn,
                                init_carry, max_steps, "cpu")
    stats, tr = first
    assert tr["r_pos"].shape == (3, max_steps, 2)
    assert sorted(p.name for p in port_dir.iterdir()) == \
        ["batch_00000.npz", "batch_00001.npz", "batch_00002.npz"]
    # the port's files, resumed by the port and by the reference
    _assert_same(AC.run_traced_suite(_suite_args(port_dir), env_cfg,
                                     _refuse, _refuse, max_steps, "cpu"),
                 first)
    ref_env = _env(EnvConfig_ref, time_limit=1.0)
    _assert_same(AC_ref.run_traced_suite(_suite_args(port_dir), ref_env,
                                         _refuse, lambda: jnp.zeros(()),
                                         max_steps), first)

    # the reference writes its own files from the same arrays (its traced
    # rollout stubbed by one episode's arrays, which its vmap broadcasts
    # to the batch of one), and the port reads them
    cases = iter(range(3))

    def ref_rollout(state, carry, step_fn_, cfg, steps):
        i = next(cases)
        st = RO_ref.EpisodeStats(*[jnp.asarray(x[i]) for x in stats])
        trace = RO_ref.StepTrace(
            **{k: jnp.asarray(tr[k][i]) for k in RO_ref.StepTrace._fields
               if k != "aux"},
            aux=Aux(**{k: jnp.asarray(tr["aux"][k][i])
                       for k in Aux._fields}))
        return state, st, trace

    monkeypatch.setattr(RO_ref, "rollout_episode_traced", ref_rollout)
    ref_dir = tmp_path / "ref"
    ref_first = AC_ref.run_traced_suite(_suite_args(ref_dir), ref_env,
                                        None, lambda: jnp.zeros(()),
                                        max_steps)
    sub = (stats, {**{k: v for k, v in tr.items() if k != "aux"},
                   "aux": {k: tr["aux"][k] for k in Aux._fields}})
    _assert_same(ref_first, sub)
    _assert_same(AC.run_traced_suite(_suite_args(ref_dir), env_cfg, _refuse,
                                     _refuse, max_steps, "cpu"), sub)
    for name in ("batch_00000.npz", "batch_00001.npz", "batch_00002.npz"):
        a, b = np.load(port_dir / name), np.load(ref_dir / name)
        assert set(a.files) - set(b.files) == {"a_ineq_viol", "a_eq_viol"}
        assert set(b.files) < set(a.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_suite_audit_main_with_a_stub(tmp_path, monkeypatch, capsys):
    init_carry, step_fn = _stub_policy()

    def build(args, device):
        env_cfg = AC.env_config(args)
        return (env_cfg, step_fn, init_carry,
                int(env_cfg.time_limit / env_cfg.dt) + 2)

    monkeypatch.setattr(AC, "build", build)
    resume = tmp_path / "audit"
    argv = ["--num_cases", "3", "--batch", "2", "--time_limit", "1.0",
            "--resume_dir", str(resume), "--device", "cpu"]
    report = SA.main(argv)
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(report))
    parts = [np.load(resume / f"batch_{s:05d}.npz") for s in (0, 2)]
    stats = RO.EpisodeStats(**{k: np.concatenate([p[f"s_{k}"]
                                                  for p in parts])
                               for k in RO.EpisodeStats._fields})
    assert report["summary"] == harness.summarize(
        stats, _env(time_limit=1.0))
    assert report["n_timeouts"] == 3 == len(report["timeout_episodes"])
    assert set(report["timeout_classes"]) <= set(TT.TIMEOUT_CLASSES)
    assert report["per_case"]["timeout"] == [1, 1, 1]
    monkeypatch.setattr(AC, "build", lambda args, device: (
        build(args, device)[0], _refuse, _refuse, 6))
    assert SA.main(argv) == report

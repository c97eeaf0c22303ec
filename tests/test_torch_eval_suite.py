"""The port's evaluation script (scripts/eval_suite_torch.py) against the
reference's (scripts/eval_suite.py): the same options, and for the MPC
policies the same configurations.

- Option strings: the port's parser takes every option of the reference's,
  plus only its documented port-only ones (``--device``, ``--weights``,
  ``--traced``, ``--seed_per_case``); the policies offered are the same
  and every shared option's default is the reference's, but for the
  protocol's defaults the port documents (scenario, time limit, batch).
- For plain SICNav (``campc``, ``campc_cvmm``, ``--privileged``,
  ``--no-ral``, ``--wall_margin``, ``--mpc_kw``, the cascade flags, the
  observation path ``--noise_std 0.05 --kalman_filter``, ``--soc`` and
  ``--ipm_early_exit``), for the fused controller's flags and for DWA's
  window: the MPCConfig, IPMSettings, KFConfig, NoiseConfig,
  ForecasterConfig, DWAConfig and EnvConfig the port builds equal those
  the reference script builds, captured by monkeypatching the functions
  each script hands them to (``harness.evaluate_policy`` ends the run).
"""

import argparse
import dataclasses
import pathlib
import sys

import pytest
import torch

import sicnav_tpu.diffusion.mid as MID_ref
import sicnav_tpu.harness as H_ref
import sicnav_tpu.mpc.campc as C_ref
import sicnav_tpu.mpc.sicnav_diffusion as SD_ref
import sicnav_tpu.policies.dwa as DWA_ref
import sicnav_tpu.utils.robustness as RB_ref
import sicnav_tpu.utils.state_filter as SF_ref
import sicnav_tpu_torch.harness as H
import sicnav_tpu_torch.mpc.campc as C
import sicnav_tpu_torch.mpc.sicnav_diffusion as SD
import sicnav_tpu_torch.policies.dwa as DWA
import sicnav_tpu_torch.utils.robustness as RB
import sicnav_tpu_torch.utils.state_filter as SF

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import eval_suite as ES_ref  # noqa: E402
import eval_suite_torch as ES  # noqa: E402

PORT_ONLY = {"--device", "--weights", "--traced", "--seed_per_case"}
PORT_DEFAULTS = {"scenario", "time_limit", "batch"}
COMMON = ["--scenario", "hallway_bottleneck", "--time_limit", "30",
          "--num_cases", "2", "--batch", "2"]
CASCADE = ["--multi_start", "4", "--adaptive_effort", "2", "--evasive_brake",
           "--wall_aware_realism", "--accept_margin", "0.03",
           "--brake_margin", "0.01", "--brake_horizon", "2",
           "--hard_wall_stages", "1", "--no-brake_on_unreal_guess",
           "--stage_margin", "0.02", "--rescue_best_margin",
           "--ref_type", "goal_tile"]
CASES = {
    "campc": ["--policy", "campc"],
    "campc_cvmm": ["--policy", "campc_cvmm"],
    "privileged": ["--policy", "campc", "--privileged"],
    "no_ral": ["--policy", "campc", "--no-ral", "--door_yield"],
    "wall_margin": ["--policy", "campc_cvmm", "--wall_margin", "0.08"],
    "mpc_kw": ["--policy", "campc", "--mpc_kw",
               "door_yield_hold_max=8,accept_margin=0.02,door_yield=True"],
    "cascade": ["--policy", "campc", *CASCADE],
    "observed": ["--policy", "campc", "--privileged", "--noise_std", "0.05",
                 "--kalman_filter"],
    "solver": ["--policy", "campc", "--soc", "--ipm_early_exit", "1e-4",
               "--ipm_iters", "12"],
    "fused_observed": ["--policy", "sicnav_diffusion", "--noise_std", "0.1",
                       "--kalman_filter", "--kf_accel_std", "1.0"],
    "fused_flags": ["--policy", "sicnav_diffusion", "--no-ral",
                    "--no-door_yield", "--goal_dynamics",
                    "--no_close_to_preds", "--wall_margin", "0.07",
                    "--mpc_kw", "adaptive_effort=3", "--num_samples", "16",
                    "--num_ret_samples", "8", "--ddim_stride", "4", "--soc",
                    *CASCADE],
    "noise_only": ["--policy", "sicnav_diffusion", "--noise_std", "0.02"],
    "dwa": ["--policy", "dwa", "--dwa_nv", "4", "--dwa_nw", "32"],
}


class _Captured(Exception):
    pass


def _parser(monkeypatch, run):
    """The ArgumentParser ``run()`` builds, caught at its parse_args."""
    def catch(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Captured) as e:
        run()
    monkeypatch.undo()
    return e.value.args[0]


def _options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_options_cover_the_reference(monkeypatch):
    ref = _options(_parser(monkeypatch, ES_ref.main))
    port = _options(_parser(monkeypatch, lambda: ES.parse_args([])))
    strings = {s for a in ref.values() for s in a.option_strings}
    strings_p = {s for a in port.values() for s in a.option_strings}
    assert strings <= strings_p, strings - strings_p
    assert strings_p - strings == PORT_ONLY | {"-h", "--help"} - strings
    assert port["policy"].choices == ref["policy"].choices
    for dest, a in ref.items():
        if dest not in PORT_DEFAULTS | {"help"}:
            assert port[dest].default == a.default, dest
            assert type(port[dest]) is type(a), dest
    assert {d for d in ref if port[d].default != ref[d].default} == \
        PORT_DEFAULTS
    # the documented differences are in --help
    text = _parser(monkeypatch, lambda: ES.parse_args([])).format_help()
    for word in ("--device", "--seed_per_case", "hallway", "30 s", "batch"):
        assert word in text, word


def _capture(monkeypatch, modules, run):
    """Run a script's main with the config-taking functions of ``modules``
    (campc, sicnav_diffusion, state_filter, robustness, dwa, harness)
    recording what they are handed."""
    C_, SD_, SF_, RB_, DWA_, H_ = modules
    got = {}

    def recorder(mod, name, key, pick):
        orig = getattr(mod, name)

        def fn(*args, **kwargs):
            out = orig(*args, **kwargs)
            got[key] = pick(args, kwargs, out)
            return out
        monkeypatch.setattr(mod, name, fn)

    recorder(C_, "make_policy", "mpc", lambda a, k, out: (
        out[0].cfg, k.get("settings", a[2] if len(a) > 2 else None)))
    recorder(SD_, "make_policy", "mpc", lambda a, k, out: (
        out[0].cfg, k["settings"], k["fcfg"]))
    recorder(SF_, "filtered_policy_stateful", "kf", lambda a, k, out: a[1])
    recorder(RB_, "noisy_policy_stateful", "noise", lambda a, k, out: a[1])
    recorder(DWA_, "DWAConfig", "dwa", lambda a, k, out: out)

    def end(policy, env_cfg, *args, **kwargs):
        got["env"] = env_cfg
        raise _Captured()

    monkeypatch.setattr(H_, "evaluate_policy", end)
    with pytest.raises(_Captured):
        run()
    monkeypatch.undo()
    return got


def _same(got, want, what):
    assert (got is None) == (want is None), what
    if want is not None:
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert g == w, (what, {k: (g.get(k), v) for k, v in w.items()
                               if g.get(k) != v})


@pytest.mark.parametrize("case", list(CASES))
def test_configs_match_reference_script(monkeypatch, case):
    argv = CASES[case] + COMMON
    if argv[1] == "sicnav_diffusion":
        # the reference refuses random weights unless asked; its Flax
        # parameters are never read before evaluate_policy
        monkeypatch.setattr(MID_ref.JMIDModel, "init",
                            lambda self, *a, **k: {})
        ref_argv = argv + ["--allow_random_params"]
    else:
        ref_argv = argv
    monkeypatch.setattr(sys, "argv", ["eval_suite.py"] + ref_argv)
    want = _capture(monkeypatch, (C_ref, SD_ref, SF_ref, RB_ref, DWA_ref,
                                  H_ref), ES_ref.main)
    got = _capture(monkeypatch, (C, SD, SF, RB, DWA, H),
                   lambda: ES.main(argv + ["--device", "cpu"]))
    assert set(got) == set(want), (set(got), set(want))
    _same(got["env"], want["env"], "EnvConfig")
    for key in ("kf", "noise", "dwa"):
        _same(got.get(key), want.get(key), key)
    if "mpc" in want:
        for g, w, what in zip(got["mpc"], want["mpc"],
                              ("MPCConfig", "IPMSettings",
                               "ForecasterConfig")):
            _same(g, w, what)
    if case == "observed":
        assert got["kf"].pos_std == 0.05 and got["noise"].pos_std == 0.05

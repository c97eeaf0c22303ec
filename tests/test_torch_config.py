"""The port's INI loaders (sicnav_tpu_torch/config.py) against the
reference's (sicnav_tpu/config.py): the shipped ``configs/env.config`` and
``configs/policy.config``, and a written file with missing, malformed and
boolean keys, give the same EnvConfig / RewardConfig / MPCConfig, field
for field (floats within 1e-7, everything else equal), and the same
``config_hash``."""

import dataclasses
import math
import pathlib

import pytest

from sicnav_tpu import config as CF_ref
from sicnav_tpu_torch import config as CF

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = ROOT / "configs" / "env.config"
POLICY = ROOT / "configs" / "policy.config"
TOL = 1e-7

WRITTEN_ENV = """
[env]
time_limit = 20 extra tokens
time_step = not-a-number
randomize_attributes = no
val_size = 7
[reward]
success_reward = 2.5
progress_factor = 0.1
discomfort_penalty_factor =
[sim]
test_sim = hallway
human_num = 5
max_human_num = 7
starts_moving = 2
[humans]
visible = off
policy = sfm
radius = 0.35
A_bottleneck = 4.5
[robot]
radius = 0.35 metres
visible = maybe
"""

WRITTEN_POLICY = """
[campc]
horiz = 6
warmstart = false
ref_type = goal_tile
[mpc_env]
robot_model_8state = yes
max_rot_degrees = 45
slack_mode = acados
hums_close_to_preds = 0
num_MID_samples = x
rob_collision_capsule = on
term_q_coeff = 75.0
q_theta = 0.07
human_pred_MID = true
[humans]
time_horizon = 3.0
"""


def assert_same(port, ref, path=""):
    """Every field of the reference's dataclass in the port's, equal
    (floats within TOL)."""
    for f in dataclasses.fields(ref):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        where = f"{path}{f.name}"
        if dataclasses.is_dataclass(want):
            assert_same(got, want, where + ".")
        elif isinstance(want, float) and not isinstance(want, bool):
            assert isinstance(got, float) and math.isclose(
                got, want, rel_tol=0, abs_tol=TOL), (where, got, want)
        else:
            assert type(got) is type(want) and got == want, \
                (where, got, want)


def _written(tmp_path):
    env, pol = tmp_path / "env.config", tmp_path / "policy.config"
    env.write_text(WRITTEN_ENV)
    pol.write_text(WRITTEN_POLICY)
    return env, pol


@pytest.mark.parametrize("overrides", [
    {}, {"scenario_override": "hallway_static", "human_num_override": 4}],
    ids=["file", "overrides"])
def test_shipped_configs(overrides):
    env = CF.load_env_config(str(ENV), **overrides)
    env_ref = CF_ref.load_env_config(str(ENV), **overrides)
    assert_same(env, env_ref)
    assert_same(CF.load_mpc_config(str(POLICY), env),
                CF_ref.load_mpc_config(str(POLICY), env_ref))
    assert CF.config_hash(str(ENV), str(POLICY)) == \
        CF_ref.config_hash(str(ENV), str(POLICY))


def test_written_config(tmp_path):
    """Missing keys and unparsable values take the defaults, bools go
    through getboolean, and only the first token of a value counts."""
    env_path, pol_path = _written(tmp_path)
    env = CF.load_env_config(str(env_path))
    env_ref = CF_ref.load_env_config(str(env_path))
    assert_same(env, env_ref)
    assert (env.time_limit, env.dt, env.randomize_attributes) == \
        (20.0, 0.25, False)
    assert (env.scenario, env.human_num, env.max_humans) == ("hallway", 5, 7)
    assert env.robot_radius == 0.35 and env.robot_visible is True
    assert env.rewards.discomfort_penalty_factor == 0.5
    mpc = CF.load_mpc_config(str(pol_path), env)
    assert_same(mpc, CF_ref.load_mpc_config(str(pol_path), env_ref))
    assert mpc.robot_nx == 8 and mpc.robot_capsule and not mpc.warmstart
    assert mpc.num_mid_samples == 1 and not mpc.close_to_preds
    assert math.isclose(mpc.max_rot, math.radians(45.0), abs_tol=TOL)
    assert (mpc.num_hums, mpc.num_walls) == (7, env.wall_slots)
    assert CF.config_hash(str(env_path), str(pol_path)) == \
        CF_ref.config_hash(str(env_path), str(pol_path))
    assert CF.config_hash(str(env_path)) != \
        CF.config_hash(str(env_path), str(pol_path))


def test_empty_file_gives_the_defaults(tmp_path):
    empty = tmp_path / "empty.config"
    empty.write_text("")
    env = CF.load_env_config(str(empty))
    assert_same(env, CF_ref.load_env_config(str(empty)))
    assert env.scenario == "circle_crossing" and env.starts_moving == 0
    assert_same(CF.load_mpc_config(str(empty), env),
                CF_ref.load_mpc_config(str(empty),
                                       CF_ref.load_env_config(str(empty))))

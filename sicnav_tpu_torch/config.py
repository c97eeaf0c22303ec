"""Config loading: reference-format INI files -> typed configs (twin of
``sicnav_tpu/config.py``).

The two-tier configparser setup of the reference (env.config +
policy.config): the files in ``configs/`` parse into the port's
``EnvConfig`` / ``RewardConfig`` / ``MPCConfig`` with the same defaults
and the same lookup rule: a key's value is its first whitespace token,
read as the field's type (``getboolean`` for bools), and any error falls
back to the default.
"""

from __future__ import annotations

import configparser
import hashlib
from typing import Optional

import numpy as np

from sicnav_tpu_torch.env.types import EnvConfig, RewardConfig
from sicnav_tpu_torch.mpc.ocp import MPCConfig


def _reader(path: str):
    """``get(section, key, type, default)`` over the INI file at ``path``."""
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_string(f.read())

    def get(sec, key, typ, default):
        try:
            if typ is bool:
                return cp.getboolean(sec, key)
            return typ(cp.get(sec, key).split()[0])
        except Exception:
            return default

    return get


def load_env_config(path: str, scenario_override: Optional[str] = None,
                    human_num_override: Optional[int] = None) -> EnvConfig:
    get = _reader(path)
    rewards = RewardConfig(
        success_reward=get("reward", "success_reward", float, 1.0),
        collision_penalty=get("reward", "collision_penalty", float, -0.25),
        freezing_penalty=get("reward", "freezing_penalty", float, -0.125),
        timeout=get("reward", "timeout", float, -1.0),
        wall_collision_penalty=get("reward", "wall_collision_penalty", float,
                                   -1.0),
        discomfort_dist=get("reward", "discomfort_dist", float, 0.2),
        discomfort_penalty_factor=get("reward", "discomfort_penalty_factor",
                                      float, 0.5),
        progress_factor=get("reward", "progress_factor", float, None),
        angular_smoothness_factor=get("reward", "angular_smoothness_factor",
                                      float, None),
        linear_smoothness_factor=get("reward", "linear_smoothness_factor",
                                     float, None))

    scenario = scenario_override or get("sim", "test_sim", str,
                                        "circle_crossing")
    human_num = human_num_override or get("sim", "human_num", int, 3)
    return EnvConfig(
        time_limit=get("env", "time_limit", float, 15.0),
        dt=get("env", "time_step", float, 0.25),
        randomize_attributes=get("env", "randomize_attributes", bool, True),
        val_size=get("env", "val_size", int, 100),
        test_size=get("env", "test_size", int, 500),
        scenario=scenario,
        square_width=get("sim", "square_width", float, 5.0),
        circle_radius=get("sim", "circle_radius", float, 1.5),
        rect_width=get("sim", "rect_width", float, 2.0),
        rect_height=get("sim", "rect_height", float, 4.0),
        starts_moving=get("sim", "starts_moving", int, 0),
        human_num=human_num,
        max_humans=max(human_num, get("sim", "max_human_num", int,
                                      human_num)),
        human_policy=get("humans", "policy", str, "orca_plus"),
        human_radius=get("humans", "radius", float, 0.3),
        human_v_pref=get("humans", "v_pref", float, 1.5),
        human_visible=get("humans", "visible", bool, True),
        safety_space=get("humans", "safety_space", float, 0.01),
        sfm_A=get("humans", "A", float, 3.0),
        sfm_B=get("humans", "B", float, 0.18),
        sfm_KI=get("humans", "KI", float, 1.0),
        sfm_A_static=get("humans", "A_static", float, 2.0),
        sfm_B_static=get("humans", "B_static", float, 0.025),
        sfm_A_bottleneck=get("humans", "A_bottleneck", float, 6.0),
        sfm_B_bottleneck=get("humans", "B_bottleneck", float, 0.12),
        robot_radius=get("robot", "radius", float, 0.25),
        robot_v_pref=get("robot", "v_pref", float, 1.0),
        robot_visible=get("robot", "visible", bool, True),
        rewards=rewards)


def load_mpc_config(path: str, env_cfg: EnvConfig) -> MPCConfig:
    get = _reader(path)
    return MPCConfig(
        horiz=get("campc", "horiz", int, 4),
        orca_kkt_horiz=get("mpc_env", "orca_kkt_horiz", int, 4),
        hum_model=get("mpc_env", "hum_model", str, "orca_casadi_kkt"),
        num_hums=env_cfg.max_humans,
        num_walls=env_cfg.wall_slots,
        soft_constraints=get("campc", "soft_constraints", bool, True),
        priviledged_info=get("mpc_env", "priviledged_info", bool, False),
        human_max_speed=get("mpc_env", "human_v_max_assumption", float, 0.5),
        pref_speed=get("mpc_env", "pref_speed", float, 0.90),
        max_speed=get("mpc_env", "max_speed", float, 0.95),
        max_rev_speed=get("mpc_env", "max_rev_speed", float, 0.95),
        max_rot=float(get("mpc_env", "max_rot_degrees", float, 60.0)
                      * np.pi / 180.0),
        max_l_acc=get("mpc_env", "max_l_acc", float, 0.5),
        max_l_dcc=get("mpc_env", "max_l_dcc", float, -1.5),
        rob_rad_buffer=get("mpc_env", "rob_rad_buffer", float, 0.02),
        orca_ksi_scaling=get("mpc_env", "orca_ksi_scaling", float, 1e-2),
        orca_vxy_scaling=get("mpc_env", "orca_vxy_scaling", float, 1.0),
        orca_time_horizon=get("humans", "time_horizon", float, 2.5),
        orca_time_horizon_obst=get("humans", "time_horizon_obst", float, 1.5),
        ref_type=get("campc", "ref_type", str, "point_stab"),
        warmstart=get("campc", "warmstart", bool, True),
        # the RA-L keys (the SICNav-Diffusion policy.config)
        robot_nx=8 if get("mpc_env", "robot_model_8state", bool, False)
        else 4,
        term_q_coeff=get("mpc_env", "term_q_coeff", float, 100.0),
        term_q_theta=get("mpc_env", "term_q_theta", float, 2.0),
        r_om=get("mpc_env", "r_om", float, 0.1),
        q_x=get("mpc_env", "q_x", float, 1.0),
        q_y=get("mpc_env", "q_y", float, 1.0),
        q_theta=get("mpc_env", "q_theta", float, 0.05),
        q_v_prev=get("mpc_env", "q_v_prev", float, 2.5),
        q_om_prev=get("mpc_env", "q_om_prev", float, 0.0),
        q_v_prev_dot=get("mpc_env", "q_v_prev_dot", float, 3.5),
        q_om_prev_dot=get("mpc_env", "q_om_prev_dot", float, 0.1),
        robot_capsule=get("mpc_env", "rob_collision_capsule", bool, False),
        rob_len=get("mpc_env", "rob_len", float, 0.6),
        rob_wid=get("mpc_env", "rob_wid", float, 0.6),
        rob_len_buffer=get("mpc_env", "rob_len_buffer", float, 0.01),
        rob_wid_buffer=get("mpc_env", "rob_wid_buffer", float, 0.01),
        human_pred_mid=get("mpc_env", "human_pred_MID", bool, False),
        mid_stateful_weights=get("mpc_env", "MID_stateful_weights", bool,
                                 True),
        close_to_preds=get("mpc_env", "hums_close_to_preds", bool, True),
        num_mid_samples=get("mpc_env", "num_MID_samples", int, 1),
        momentum_warmstart=get("mpc_env", "momentum_warmstart", bool, False),
        slack_mode=get("mpc_env", "slack_mode", str, "tro"),
        dt=env_cfg.dt)


def config_hash(*paths) -> str:
    """md5 over the config files' bytes, in order: the key under which the
    reference caches the solver it generates for a configuration."""
    h = hashlib.md5()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()

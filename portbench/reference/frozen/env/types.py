"""Core dataclasses: static env configuration and the dynamic sim state
(twin of ``sicnav_tpu/env/types.py``).

The configuration dataclasses are copies of the reference's, field for
field and default for default. The world state is one NamedTuple of
fixed-shape tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# scenario rules (parity: crowd_sim_plus.py:322-451)
SCENARIOS = (
    "circle_crossing", "square_crossing", "hallway", "hallway_static",
    "hallway_static_with_back", "hallway_bottleneck", "hallway_squeeze",
    "rectangle", "left_wall", "no_walls",
)

HUMAN_POLICIES = ("orca", "orca_plus", "sfm", "linear")


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Reward terms; ``None`` disables a term (parity with the reference's
    reward-dict gating, crowd_sim_plus.py:88-130). Defaults = sicnav
    env.config [reward] plus the non-SB3 fill-ins."""
    success_reward: Optional[float] = 1.0
    collision_penalty: Optional[float] = -0.25
    freezing_penalty: Optional[float] = -0.125
    timeout: Optional[float] = -1.0
    wall_collision_penalty: Optional[float] = -1.0
    discomfort_dist: float = 0.2
    discomfort_penalty_factor: Optional[float] = 0.5
    progress_factor: Optional[float] = None
    angular_smoothness_factor: Optional[float] = None
    linear_smoothness_factor: Optional[float] = None

    @property
    def discomfort(self) -> bool:
        return self.discomfort_penalty_factor is not None


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (frozen and hashable).

    Field defaults mirror sicnav/configs/env.config.
    """
    # [env]
    time_limit: float = 15.0
    dt: float = 0.25
    randomize_attributes: bool = True
    val_size: int = 100
    test_size: int = 500
    # [sim]
    scenario: str = "hallway_bottleneck"
    square_width: float = 5.0
    circle_radius: float = 1.5
    rect_width: float = 2.0
    rect_height: float = 4.0
    starts_moving: int = 10
    human_num: int = 3
    max_humans: int = 8
    # [humans]
    human_policy: str = "orca_plus"
    human_radius: float = 0.30
    human_v_pref: float = 1.5
    human_visible: bool = True
    human_fully_observable: bool = False
    safety_space: float = 0.01
    # sfm params
    sfm_A: float = 3.0
    sfm_B: float = 0.18
    sfm_KI: float = 1.0
    sfm_A_static: float = 2.0
    sfm_B_static: float = 0.025
    sfm_A_bottleneck: float = 6.0
    sfm_B_bottleneck: float = 0.12
    # orca policy params (class defaults in orca.py:58-66; orca_plus only
    # overrides radius/safety_space from config)
    orca_neighbor_dist: float = 10.0
    orca_max_neighbors: int = 10
    orca_time_horizon: float = 2.0
    orca_time_horizon_obst: float = 0.5
    orca_max_speed: float = 1.0
    # [robot]
    robot_radius: float = 0.25
    robot_v_pref: float = 1.0
    robot_visible: bool = True
    robot_kinematics: str = "unicycle"  # "holonomic" | "unicycle"
    # rewards
    rewards: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    detailed_reward: bool = False

    def __post_init__(self):
        assert self.scenario in SCENARIOS, self.scenario
        assert self.human_policy in HUMAN_POLICIES, self.human_policy
        assert self.robot_kinematics in ("holonomic", "unicycle")

    @property
    def n_walls(self) -> int:
        return {
            "hallway": 2, "hallway_bottleneck": 4, "hallway_squeeze": 4,
            "hallway_static": 12, "hallway_static_with_back": 14,
            "rectangle": 4, "left_wall": 1,
        }.get(self.scenario, 0)

    @property
    def wall_slots(self) -> int:
        # fixed padded wall-array size (>=1 so shapes stay non-empty)
        return max(self.n_walls, 1)


class DoorParams(NamedTuple):
    """Hallway door geometry for intermediate human goals
    (parity: crowd_sim_plus.py:333-345 + human_plus.get_g_xy)."""
    has_door: torch.Tensor      # bool: scenario in hallway_static*/bottleneck
    x_mid: torch.Tensor
    y_min: torch.Tensor
    y_max: torch.Tensor
    y_mid_min: torch.Tensor
    y_mid_max: torch.Tensor
    width: torch.Tensor


class SimState(NamedTuple):
    """Complete world state: fixed-shape tensors on one device."""
    # robot
    r_pos: torch.Tensor          # (2,)
    r_vel: torch.Tensor          # (2,)
    r_theta: torch.Tensor        # ()
    r_omega: torch.Tensor        # ()
    r_goal: torch.Tensor         # (2,)
    r_radius: torch.Tensor       # ()
    r_v_pref: torch.Tensor       # ()
    # humans, padded to H = max_humans
    h_pos: torch.Tensor          # (H, 2)
    h_vel: torch.Tensor          # (H, 2)
    h_theta: torch.Tensor        # (H,)
    h_goal: torch.Tensor         # (H, 2)   current (possibly intermediate) goal
    h_final_goal: torch.Tensor   # (H, 2)
    h_radius: torch.Tensor       # (H,)
    h_v_pref: torch.Tensor       # (H,)
    h_mask: torch.Tensor         # (H,) bool
    # static obstacles, padded to W = wall_slots
    walls: torch.Tensor          # (W, 2, 2)
    wall_mask: torch.Tensor      # (W,) bool
    door: DoorParams
    # bookkeeping
    t: torch.Tensor              # () global time
    step_idx: torch.Tensor       # () int32
    prev_dist_to_goal: torch.Tensor  # ()
    prev_ang: torch.Tensor       # () previous action angular component
    has_prev_ang: torch.Tensor   # () bool
    prev_lin: torch.Tensor       # ()
    has_prev_lin: torch.Tensor   # () bool
    human_times: torch.Tensor    # (H,)
    done: torch.Tensor           # () bool


class StepInfo(NamedTuple):
    """Per-step reward decomposition + event flags (parity: the info-object
    dict the reference step() returns, crowd_sim_plus.py:1096-1172 and
    info_plus.py)."""
    reach_goal: torch.Tensor         # bool
    timeout: torch.Tensor            # bool
    collision: torch.Tensor          # bool
    wall_collision: torch.Tensor     # bool
    frozen: torch.Tensor             # bool
    danger: torch.Tensor             # bool (dmin < discomfort_dist)
    dmin: torch.Tensor               # float
    # reward components (0 when inactive)
    r_success: torch.Tensor
    r_timeout: torch.Tensor
    r_collision: torch.Tensor
    r_wall: torch.Tensor
    r_danger: torch.Tensor
    r_progress: torch.Tensor
    r_freezing: torch.Tensor
    r_angular: torch.Tensor
    r_linear: torch.Tensor
    total_reward: torch.Tensor
    done: torch.Tensor               # bool

"""Static-obstacle (wall) layouts per scenario rule
(twin of ``sicnav_tpu/env/walls.py``).

Host-side numpy construction (walls are deterministic functions of the
config; parity: crowd_sim_plus.py generate_static_obstacles :322-422).
Returns padded (W, 2, 2) arrays + mask + hallway-door parameters.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.frozen.env.types import DoorParams, EnvConfig


def build_walls(cfg: EnvConfig):
    """Returns (walls (W,2,2) float32, wall_mask (W,), DoorParams of numpy
    scalars). W = cfg.wall_slots."""
    rule = cfg.scenario
    cr = cfg.circle_radius
    rw, rh = cfg.rect_width, cfg.rect_height

    door = dict(has_door=False, x_mid=0.0, y_min=0.0, y_max=0.0,
                y_mid_min=0.0, y_mid_max=0.0, width=1.0)
    obstacles = []

    if rule in ("hallway_static", "hallway_static_with_back",
                "hallway_bottleneck", "hallway_squeeze"):
        door_y_max = cr - cfg.robot_radius * 2.0
        door_y_min = -cr + cfg.robot_radius * 2.0
        door_x_mid = 0.0
        door_y_mid_max = door_y_max + (door_y_min - door_y_max) * 0.40
        door_y_mid_min = door_y_max + (door_y_min - door_y_max) * 0.60
        door_width = 0.5 * rw if rule == "hallway_squeeze" else 1.0
        door_x_left = door_x_mid - door_width / 2.0
        door_x_left_mid = door_x_left + ((-rw * 0.5) - door_x_left) * 0.75
        door_x_right = door_x_mid + door_width / 2.0
        door_x_right_mid = door_x_right + (rw * 0.5 - door_x_right) * 0.75
        door.update(has_door=rule != "hallway_squeeze", x_mid=door_x_mid,
                    y_min=door_y_min, y_max=door_y_max,
                    y_mid_min=door_y_mid_min, y_mid_max=door_y_mid_max,
                    width=door_width)

        if rule == "hallway_squeeze":
            y_mid = 0.0
            obstacles = [
                [(-rw * 0.5, -cr * 2.5), (door_x_left, y_mid)],
                [(door_x_left, y_mid), (-rw * 0.5, cr * 2.5)],
                [(rw * 0.5, -cr * 2.5), (door_x_right, y_mid)],
                [(door_x_right, y_mid), (rw * 0.5, cr * 2.5)],
            ]
        else:
            obstacles = [
                [(-rw * 0.5, -rh), (-rw * 0.5, rh)],   # left wall
                [(rw * 0.5, -rh), (rw * 0.5, rh)],     # right wall
            ]
            if "hallway_static" in rule:
                obstacles += [
                    [(-rw * 0.5, door_y_min), (door_x_left_mid, door_y_min)],
                    [(door_x_left_mid, door_y_min), (door_x_left, door_y_mid_min)],
                    [(door_x_left, door_y_mid_min), (door_x_left, door_y_mid_max)],
                    [(door_x_left, door_y_mid_max), (door_x_left_mid, door_y_max)],
                    [(door_x_left_mid, door_y_max), (-rw * 0.5, door_y_max)],
                    [(rw * 0.5, door_y_min), (door_x_right_mid, door_y_min)],
                    [(door_x_right_mid, door_y_min), (door_x_right, door_y_mid_min)],
                    [(door_x_right, door_y_mid_min), (door_x_right, door_y_mid_max)],
                    [(door_x_right, door_y_mid_max), (door_x_right_mid, door_y_max)],
                    [(door_x_right_mid, door_y_max), (rw * 0.5, door_y_max)],
                ]
            elif rule == "hallway_bottleneck":
                y_mid = 0.0
                obstacles += [
                    [(-rw * 0.5, y_mid), (door_x_left, y_mid)],
                    [(door_x_right, y_mid), (rw * 0.5, y_mid)],
                ]
            if rule == "hallway_static_with_back":
                obstacles += [
                    [(-rw * 0.5, -rh * 0.5), (rw * 0.5, -rh * 0.5)],
                    [(-rw * 0.5, rh * 0.5), (rw * 0.5, rh * 0.5)],
                ]
    elif rule == "hallway":
        obstacles = [
            [(-rw * 0.5, -rh), (-rw * 0.5, rh)],
            [(rw * 0.5, -rh), (rw * 0.5, rh)],
        ]
    elif rule == "rectangle":
        obstacles = [
            [(-rw * 0.5, -rh * 0.5), (-rw * 0.5, rh * 0.5)],
            [(rw * 0.5, -rh * 0.5), (rw * 0.5, rh * 0.5)],
            [(-rw * 0.5, -rh * 0.5), (rw * 0.5, -rh * 0.5)],
            [(-rw * 0.5, rh * 0.5), (rw * 0.5, rh * 0.5)],
        ]
    elif rule == "left_wall":
        obstacles = [
            [(-rw * 0.5, -rh * 1000.0), (-rw * 0.5, rh * 1000.0)],
        ]
    # circle_crossing / square_crossing / no_walls: none

    W = cfg.wall_slots
    walls = np.zeros((W, 2, 2), np.float32)
    mask = np.zeros((W,), bool)
    for i, ((x1, y1), (x2, y2)) in enumerate(obstacles):
        walls[i, 0] = (x1, y1)
        walls[i, 1] = (x2, y2)
        mask[i] = True

    door_params = DoorParams(
        has_door=np.bool_(door["has_door"]),
        x_mid=np.float32(door["x_mid"]), y_min=np.float32(door["y_min"]),
        y_max=np.float32(door["y_max"]), y_mid_min=np.float32(door["y_mid_min"]),
        y_mid_max=np.float32(door["y_mid_max"]), width=np.float32(door["width"]))
    return walls, mask, door_params

"""Scenario generation: human start/goal placement (twin of
``sicnav_tpu/env/scenarios.py``).

``generate_host`` is a copy of the reference's numpy generator: it mirrors
the original simulator's RNG call sequence exactly
(``np.random.default_rng(counter_offset + case)`` and the same order of
draws), so a given (phase, case) pair produces the identical layout. The
on-device generator comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sicnav_tpu_torch.env.types import EnvConfig

# phase -> case counter offset (crowd_sim_plus.py:658-659 with
# case_capacity val=1000, test=1000)
CASE_OFFSET = {"train": 2000, "val": 0, "test": 1000}


def _point_to_seg_dist_np(w, p):
    a, b = w[0], w[1]
    d = b - a
    dd = float(np.dot(d, d))
    if dd == 0.0:
        return float(np.linalg.norm(p - a))
    u = float(np.clip(np.dot(p - a, d) / dd, 0.0, 1.0))
    return float(np.linalg.norm(a + u * d - p))


def generate_host(cfg: EnvConfig, case: int, phase: str = "test",
                  walls: np.ndarray = None, wall_mask: np.ndarray = None
                  ) -> Tuple[np.ndarray, ...]:
    """Generate human (pos, goal, v_pref, radius, theta) arrays for a seeded
    test case, replicating the reference RNG sequence.

    Returns (h_pos (H,2), h_goal (H,2), h_theta (H,), h_radius (H,),
    h_v_pref (H,), h_mask (H,)) padded to cfg.max_humans.
    """
    seed = CASE_OFFSET[phase] + case
    np.random.seed(seed % (2 ** 32))  # legacy seed kept for repeatability
    rng = np.random.default_rng(seed)

    rule = cfg.scenario
    n = cfg.human_num
    H = cfg.max_humans
    assert n <= H

    robot_pos = np.array([0.0, -cfg.circle_radius])
    robot_goal = np.array([0.0, cfg.circle_radius])
    robot_radius = cfg.robot_radius
    discomfort = cfg.rewards.discomfort_dist

    humans = []  # (pos, goal, v_pref, radius, theta)

    def agents_so_far():
        out = [(robot_pos, robot_goal, robot_radius)]
        out += [(h[0], h[1], h[3]) for h in humans]
        return out

    wall_list = []
    if walls is not None:
        for i in range(len(walls)):
            if wall_mask[i]:
                wall_list.append(np.asarray(walls[i], np.float64))

    for _ in range(n):
        radius = cfg.human_radius
        v_pref = cfg.human_v_pref

        if rule == "circle_crossing":
            if cfg.randomize_attributes:
                v_pref = rng.uniform(0.5, 1.5)
            while True:
                angle = rng.random() * np.pi * 2
                px_noise = (rng.random() - 0.5) * v_pref
                py_noise = (rng.random() - 0.5) * v_pref
                px = cfg.circle_radius * np.cos(angle) + px_noise
                py = cfg.circle_radius * np.sin(angle) + py_noise
                collide = False
                for (apos, agoal, arad) in agents_so_far():
                    min_dist = radius + arad + discomfort
                    if (np.linalg.norm((px - apos[0], py - apos[1])) < min_dist or
                            np.linalg.norm((px - agoal[0], py - agoal[1])) < min_dist):
                        collide = True
                        break
                if not collide:
                    break
            humans.append((np.array([px, py]), np.array([-px, -py]),
                           v_pref, radius, 0.0))

        elif rule == "square_crossing":
            if cfg.randomize_attributes:
                v_pref = rng.uniform(0.5, 1.5)
            sign = -1 if rng.random() > 0.5 else 1
            while True:
                px = rng.random() * cfg.square_width * 0.5 * sign
                py = (rng.random() - 0.5) * cfg.square_width
                collide = any(
                    np.linalg.norm((px - a[0][0], py - a[0][1])) < radius + a[2] + discomfort
                    for a in agents_so_far())
                if not collide:
                    break
            while True:
                gx = rng.random() * cfg.square_width * 0.5 * -sign
                gy = (rng.random() - 0.5) * cfg.square_width
                collide = any(
                    np.linalg.norm((gx - a[1][0], gy - a[1][1])) < radius + a[2] + discomfort
                    for a in agents_so_far())
                if not collide:
                    break
            humans.append((np.array([px, py]), np.array([gx, gy]),
                           v_pref, radius, 0.0))

        else:
            # hallway family (crowd_sim_plus.py:522-605)
            effective_rect_height = cfg.rect_height
            while True:
                if cfg.randomize_attributes:
                    v_pref = rng.uniform(0.5, 1.5)
                dir_sign = 1 if rng.random() < 0.15 else -1
                prob_right = 0.8
                right_num = prob_right if dir_sign > 0 else 1 - prob_right
                wor_sign = -1 if rng.random() < right_num else 1
                prob_cross = 0.3
                if rng.random() < right_num:
                    prob_cross = 1 - prob_cross
                cross_sign = -wor_sign if rng.random() < prob_cross else wor_sign

                px = rng.random() * 0.5 * wor_sign * (cfg.rect_width - radius * 2)
                py = (rng.random() * 0.25 * dir_sign * cfg.circle_radius *
                      (effective_rect_height - radius * 2))
                collide = False
                # robot proximity with discomfort buffer
                if np.linalg.norm((px - robot_pos[0], py - robot_pos[1])) < \
                        radius + robot_radius + discomfort:
                    collide = True
                # all agents without buffer
                for (apos, _, arad) in agents_so_far():
                    if np.linalg.norm((px - apos[0], py - apos[1])) < radius + arad:
                        collide = True
                        break
                if not collide:
                    for w in wall_list:
                        if abs(_point_to_seg_dist_np(w, np.array([px, py]))) < radius + 0.01:
                            collide = True
                            break
                if collide:
                    effective_rect_height *= 1.1
                    continue

                gx = rng.random() * 0.5 * cross_sign * (cfg.rect_width - radius * 2)
                gy = (rng.random() * 0.5 * -dir_sign * cfg.circle_radius *
                      (effective_rect_height - radius * 2))
                collide = False
                for (_, agoal, arad) in agents_so_far():
                    if np.linalg.norm((gx - agoal[0], gy - agoal[1])) < radius + arad:
                        collide = True
                        break
                if not collide:
                    for w in wall_list:
                        if abs(_point_to_seg_dist_np(w, np.array([gx, gy]))) < radius:
                            collide = True
                            break
                if not collide:
                    break
                effective_rect_height *= 1.1
            theta = float(np.arctan2(gy - py, gx - px))
            humans.append((np.array([px, py]), np.array([gx, gy]),
                           v_pref, radius, theta))

    h_pos = np.zeros((H, 2), np.float32)
    h_goal = np.zeros((H, 2), np.float32)
    h_theta = np.zeros((H,), np.float32)
    h_radius = np.zeros((H,), np.float32)
    h_v_pref = np.zeros((H,), np.float32)
    h_mask = np.zeros((H,), bool)
    for i, (p, g, vp, r, th) in enumerate(humans):
        h_pos[i] = p
        h_goal[i] = g
        h_theta[i] = th
        h_radius[i] = r
        h_v_pref[i] = vp
        h_mask[i] = True
    return h_pos, h_goal, h_theta, h_radius, h_v_pref, h_mask

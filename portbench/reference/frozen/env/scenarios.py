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

import math

import numpy as np
import torch

from portbench.reference.frozen.env.types import EnvConfig
from portbench.reference.frozen.ops.geometry import point_to_segment_dist

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


# ---------------------------------------------------------------------------
# On-device generation (bounded rejection, for batched training resets)
# ---------------------------------------------------------------------------

_TRIES = 64


def _family(cfg: EnvConfig) -> str:
    if cfg.scenario in ("circle_crossing", "square_crossing"):
        return cfg.scenario
    return "hallway"


def device_draws(cfg: EnvConfig, n: int, generator=None, device=None):
    """The unit uniform draws of ``generate_device`` for n episodes, each
    with a (n, max_humans) lead: circle (v_pref, tries (.., _TRIES, 3)),
    square (v_pref, side, start tries (.., _TRIES, 2), goal tries), hallway
    (v_pref, start tries (.., _TRIES, 6), goal tries (.., _TRIES, 2)). The
    reference draws the same per human from its keys."""
    H = cfg.max_humans

    def u(*shape):
        return torch.rand((n, H) + shape, generator=generator, device=device)

    family = _family(cfg)
    if family == "circle_crossing":
        return u(), u(_TRIES, 3)
    if family == "square_crossing":
        return u(), u(), u(_TRIES, 2), u(_TRIES, 2)
    return u(), u(_TRIES, 6), u(_TRIES, 2)


def _first_valid(bad):
    """Index of the first candidate that is not ``bad`` (0 when all are)."""
    return torch.argmax((~bad).to(torch.uint8), dim=-1)


def _take(x, idx):
    """x (n, T, 2)[arange n, idx]."""
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, 2))[:, 0]


def _too_close(p, apos, arad_min, amask):
    """(n, T) candidates p (n, T, 2) within ``arad_min`` (n, A) of an agent
    of ``apos`` (n, A, 2) where ``amask`` (n, A)."""
    d = torch.linalg.norm(p[:, :, None, :] - apos[:, None, :, :], dim=-1)
    return (amask[:, None, :] & (d < arad_min[:, None, :])).any(dim=-1)


def _wall_dist(q, walls, wall_mask):
    """Distance of points q (n, T, 2) to the nearest active wall."""
    d = point_to_segment_dist(walls[:, 0], walls[:, 1], q[..., None, :])
    return torch.where(wall_mask, d, torch.full_like(d, math.inf)).amin(-1)


def generate_device(cfg: EnvConfig, n: int, walls, wall_mask, generator=None,
                    draws=None):
    """Scenario generation for n episodes on the device of ``walls``: the
    reference's ``generate_device`` with a leading episode axis. Humans are
    placed one after another, each rejected against the robot and the
    humans before it. ``draws`` (see ``device_draws``) replaces the draws
    from ``generator``.

    Returns (h_pos (n, H, 2), h_goal (n, H, 2), h_theta (n, H), h_radius
    (n, H), h_v_pref (n, H), h_mask (n, H)), padded to cfg.max_humans.
    """
    dev = walls.device
    H = cfg.max_humans
    if draws is None:
        draws = device_draws(cfg, n, generator, dev)
    family = _family(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.zeros((n, H, 2), **f32)
    goal = torch.zeros((n, H, 2), **f32)
    vp = torch.zeros((n, H), **f32)
    rad = torch.zeros((n, H), **f32)
    theta = torch.zeros((n, H), **f32)
    mask = torch.zeros((n, H), dtype=torch.bool, device=dev)
    # constants are filled on the device, not copied from the host: a copy
    # would make the host wait for the card (the DQN collect step draws
    # fresh resets every step)
    robot_pos = torch.zeros((n, 1, 2), **f32)
    robot_pos[..., 1] = -cfg.circle_radius
    robot_goal = torch.zeros((n, 1, 2), **f32)
    robot_goal[..., 1] = cfg.circle_radius
    robot_rad = torch.full((n, 1), cfg.robot_radius, **f32)
    robot_mask = torch.ones((n, 1), dtype=torch.bool, device=dev)
    radius = torch.full((), cfg.human_radius, **f32)
    discomfort = cfg.rewards.discomfort_dist

    for i in range(cfg.human_num):
        d_i = [x[:, i] for x in draws]
        v_pref = (d_i[0] + 0.5 if cfg.randomize_attributes else
                  torch.full((n,), cfg.human_v_pref, **f32))
        apos = torch.cat([robot_pos, pos], dim=1)
        agoal = torch.cat([robot_goal, goal], dim=1)
        arad = torch.cat([robot_rad, rad], dim=1)
        amask = torch.cat([robot_mask, mask], dim=1)
        th = torch.zeros((n,), **f32)
        if family == "circle_crossing":
            u = d_i[1]
            angle = u[..., 0] * 2 * math.pi
            noise = (u[..., 1:3] - 0.5) * v_pref[:, None, None]
            p = cfg.circle_radius * torch.stack(
                [torch.cos(angle), torch.sin(angle)], -1) + noise
            min_dist = radius + arad + discomfort
            bad = _too_close(p, apos, min_dist, amask) | \
                _too_close(p, agoal, min_dist, amask)
            p_i = _take(p, _first_valid(bad))
            g_i = -p_i
        elif family == "square_crossing":
            _, side, up, ug = d_i
            sign = torch.where(side > 0.5, -1.0, 1.0)[:, None]
            W = cfg.square_width
            p = torch.stack([up[..., 0] * W * 0.5 * sign,
                             (up[..., 1] - 0.5) * W], -1)
            g = torch.stack([ug[..., 0] * W * 0.5 * -sign,
                             (ug[..., 1] - 0.5) * W], -1)
            min_dist = radius + arad + discomfort
            p_i = _take(p, _first_valid(_too_close(p, apos, min_dist, amask)))
            g_i = _take(g, _first_valid(_too_close(g, agoal, min_dist,
                                                   amask)))
        else:
            _, u, ug = d_i
            dir_sign = torch.where(u[..., 0] < 0.15, 1.0, -1.0)
            right_num = torch.where(dir_sign > 0, 0.8, 0.2)
            wor_sign = torch.where(u[..., 1] < right_num, -1.0, 1.0)
            prob_cross = torch.where(u[..., 2] < right_num, 0.7, 0.3)
            cross_sign = torch.where(u[..., 3] < prob_cross, -wor_sign,
                                     wor_sign)
            width = cfg.rect_width - radius * 2
            height = cfg.rect_height - radius * 2
            p = torch.stack([
                u[..., 4] * 0.5 * wor_sign * width,
                u[..., 5] * 0.25 * dir_sign * cfg.circle_radius * height], -1)
            g = torch.stack([
                ug[..., 0] * 0.5 * cross_sign * width,
                ug[..., 1] * 0.5 * -dir_sign * cfg.circle_radius * height], -1)
            bad = _too_close(p, apos, radius + arad, amask)
            bad |= torch.linalg.norm(p - robot_pos, dim=-1) < \
                radius + cfg.robot_radius + discomfort
            bad |= _too_close(g, agoal, radius + arad, amask)
            bad |= _wall_dist(p, walls, wall_mask) < radius + 0.01
            bad |= _wall_dist(g, walls, wall_mask) < radius
            idx = _first_valid(bad)
            p_i, g_i = _take(p, idx), _take(g, idx)
            th = torch.atan2(g_i[:, 1] - p_i[:, 1], g_i[:, 0] - p_i[:, 0])
        pos[:, i] = p_i
        goal[:, i] = g_i
        vp[:, i] = v_pref
        rad[:, i] = radius
        theta[:, i] = th
        mask[:, i] = True
    return pos, goal, theta, rad, vp, mask

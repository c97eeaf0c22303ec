"""Host-side episode rendering with matplotlib (twin of
``sicnav_tpu/utils/render.py``), the reference simulator's video mode:
agents as circles with per-human goals and ID labels, walls as segments,
the robot's FOV wedge, the MPC's plan and guess overlays, per-human
forecast fans with KDE-weight-coded opacity, MPC-predicted human
trajectories and a time annotation; writes mp4 (ffmpeg) or gif (pillow).

matplotlib is imported inside ``render_episode``; without it the call
raises an ImportError that names the package. Nothing on the card's paths
renders.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _rot_np(theta, p):
    """Rotate points by -theta (world -> robot heading frame), numpy."""
    c, s = np.cos(theta), np.sin(theta)
    x = p[..., 0] * c + p[..., 1] * s
    y = -p[..., 0] * s + p[..., 1] * c
    return np.stack([x, y], axis=-1)


def _to_robocentric(points, r_pos_t, r_theta_t):
    """points: (T, ..., 2) world-frame per-step overlays -> robot frame."""
    out = np.array(points, dtype=np.float64, copy=True)
    for t in range(out.shape[0]):
        out[t] = _rot_np(r_theta_t[t], out[t] - r_pos_t[t])
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def render_episode(traj, cfg, output_file: Optional[str] = None,
                   plans: Optional[np.ndarray] = None,
                   guesses: Optional[np.ndarray] = None,
                   human_plans: Optional[np.ndarray] = None,
                   forecasts: Optional[np.ndarray] = None,
                   forecast_weights: Optional[np.ndarray] = None,
                   fps: int = 4, robocentric: bool = False,
                   fov_deg: Optional[float] = None,
                   max_fan: int = 10):
    """traj: stacked SimState with a leading time axis (tensors on any
    device, e.g. ``crowd_sim.stack`` of an episode's states).

    plans: optional (T, K+1, 2) robot MPC plan per step (reference
      ``all_opt_x``, crowd_sim_plus.py:1475).
    guesses: optional (T, K+1, 2) robot MPC *guess* (warmstart) trajectory
      per step (reference guess overlay, crowd_sim_plus.py:1480-1489).
    human_plans: optional (T, H, K+1, 2) MPC-predicted human trajectories.
    forecasts: optional (T, H, k, F, 2) human forecast samples per step.
    forecast_weights: optional (T, H, k) log-weights; opacity encodes the
      normalized weight of each forecast sample (reference fan rendering).
    robocentric: render in the robot's heading frame (the reference's
      robocentric video mode) — robot pinned at the origin facing +x; ALL
      overlays are transformed with the same per-step pose.
    fov_deg: draw the robot's field-of-view wedge; None = no wedge.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "render_episode needs matplotlib, which is not installed "
            "(the card's machine has none: render on a host that has it)"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation, patches

    # world-frame robot pose per step, captured BEFORE any transform so
    # overlays can be moved into the same frame as the trajectory.
    r_pos_w = _np(traj.r_pos)
    r_theta_w = _np(traj.r_theta)
    plans, guesses, human_plans, forecasts = (
        None if x is None else _np(x)
        for x in (plans, guesses, human_plans, forecasts))

    if robocentric:
        from sicnav_tpu_torch.env.occlusion import robocentric_state
        traj = robocentric_state(traj)
        if plans is not None:
            plans = _to_robocentric(plans, r_pos_w, r_theta_w)
        if guesses is not None:
            guesses = _to_robocentric(guesses, r_pos_w, r_theta_w)
        if human_plans is not None:
            human_plans = _to_robocentric(
                human_plans, r_pos_w, r_theta_w)
        if forecasts is not None:
            forecasts = _to_robocentric(
                forecasts, r_pos_w, r_theta_w)

    r_pos = _np(traj.r_pos)
    r_theta = _np(traj.r_theta)
    r_rad = float(_np(traj.r_radius)[0])
    r_goal_t = _np(traj.r_goal)
    r_goal = r_goal_t[0]
    h_pos = _np(traj.h_pos)
    h_goal_t = _np(traj.h_goal)
    h_rad = _np(traj.h_radius)[0]
    h_mask = _np(traj.h_mask)[0]
    walls_t = _np(traj.walls)
    walls = walls_t[0]
    wall_mask = _np(traj.wall_mask)[0]
    T = r_pos.shape[0]
    H = h_pos.shape[1]

    if forecast_weights is not None and forecasts is not None:
        lw_ = _np(forecast_weights).astype(np.float64)
        w_ = np.exp(lw_ - lw_.max(axis=-1, keepdims=True))
        w_ = w_ / np.maximum(w_.sum(axis=-1, keepdims=True), 1e-12)
        fc_alpha = 0.15 + 0.75 * (w_ / np.maximum(
            w_.max(axis=-1, keepdims=True), 1e-12))      # (T, H, k)
    else:
        fc_alpha = None

    fig, ax = plt.subplots(figsize=(7, 7))
    lim = max(4.0, np.abs(r_pos).max() + 1.0,
              np.abs(h_pos[:, h_mask]).max() + 1.0 if h_mask.any() else 0.0)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")

    wall_lines = []
    for w in range(walls.shape[0]):
        if wall_mask[w]:
            ln, = ax.plot(walls[w, :, 0], walls[w, :, 1], "k-", lw=2)
            wall_lines.append((w, ln))
    goal_marker, = ax.plot(*r_goal, "r*", markersize=14, zorder=3)

    robot_c = patches.Circle(r_pos[0], r_rad, fc="gold", ec="k", zorder=5)
    ax.add_patch(robot_c)
    heading_line, = ax.plot([], [], "k-", lw=1.2, zorder=6)
    fov_wedge = None
    if fov_deg is not None:
        fov_wedge = patches.Wedge(
            r_pos[0], lim * 2.0, 0.0, 0.0, fc="yellow", alpha=0.08,
            ec="none", zorder=0)
        ax.add_patch(fov_wedge)

    human_cs, human_ids, human_goals = [], [], []
    cmap = plt.get_cmap("tab10")
    for i in range(H):
        col = cmap(i % 10)
        c = patches.Circle(h_pos[0, i], h_rad[i], fc=col, ec="k",
                           alpha=0.8 if h_mask[i] else 0.0, zorder=2)
        ax.add_patch(c)
        human_cs.append(c)
        txt = ax.text(h_pos[0, i, 0], h_pos[0, i, 1], str(i),
                      ha="center", va="center", fontsize=8, zorder=7,
                      alpha=1.0 if h_mask[i] else 0.0)
        human_ids.append(txt)
        gm, = ax.plot([h_goal_t[0, i, 0]], [h_goal_t[0, i, 1]], "+",
                      color=col, markersize=9, zorder=1,
                      alpha=0.9 if h_mask[i] else 0.0)
        human_goals.append(gm)

    plan_line, = ax.plot([], [], "r--o", lw=1.5, markersize=3, zorder=4,
                         label="MPC plan")
    guess_line, = ax.plot([], [], "m:", lw=1.3, zorder=4, label="MPC guess")
    hplan_lines = [ax.plot([], [], "--", color=cmap(i % 10), lw=0.9,
                           alpha=0.7, zorder=3)[0] for i in range(H)]
    k_fan = 0 if forecasts is None else min(forecasts.shape[2], max_fan)
    fc_lines = [[ax.plot([], [], "-", color=cmap(i % 10), lw=0.7,
                         alpha=0.3, zorder=1)[0] for _ in range(k_fan)]
                for i in range(H)]
    time_text = ax.text(0.02, 0.97, "", transform=ax.transAxes, va="top")
    if plans is not None or guesses is not None:
        ax.legend(loc="upper right", fontsize=8)

    def update(t):
        robot_c.center = r_pos[t]
        th = float(r_theta[t])
        heading_line.set_data(
            [r_pos[t, 0], r_pos[t, 0] + r_rad * 1.6 * np.cos(th)],
            [r_pos[t, 1], r_pos[t, 1] + r_rad * 1.6 * np.sin(th)])
        if fov_wedge is not None:
            fov_wedge.set_center(tuple(r_pos[t]))
            fov_wedge.set_theta1(np.degrees(th) - fov_deg / 2.0)
            fov_wedge.set_theta2(np.degrees(th) + fov_deg / 2.0)
        if robocentric:
            for w, ln in wall_lines:
                ln.set_data(walls_t[t, w, :, 0], walls_t[t, w, :, 1])
            goal_marker.set_data([r_goal_t[t, 0]], [r_goal_t[t, 1]])
        for i in range(H):
            human_cs[i].center = h_pos[t, i]
            human_ids[i].set_position(h_pos[t, i])
            human_goals[i].set_data([h_goal_t[t, i, 0]], [h_goal_t[t, i, 1]])
        if plans is not None:
            plan_line.set_data(plans[t, :, 0], plans[t, :, 1])
        if guesses is not None:
            guess_line.set_data(guesses[t, :, 0], guesses[t, :, 1])
        if human_plans is not None:
            for i in range(H):
                if h_mask[i]:
                    hplan_lines[i].set_data(human_plans[t, i, :, 0],
                                            human_plans[t, i, :, 1])
        if forecasts is not None:
            for i in range(H):
                for j in range(k_fan):
                    fc_lines[i][j].set_data(forecasts[t, i, j, :, 0],
                                            forecasts[t, i, j, :, 1])
                    if fc_alpha is not None and h_mask[i]:
                        fc_lines[i][j].set_alpha(float(fc_alpha[t, i, j]))
        time_text.set_text(f"t = {t * cfg.dt:.2f}s")
        return [robot_c] + human_cs + [plan_line, guess_line, time_text]

    anim = animation.FuncAnimation(fig, update, frames=T, blit=False)
    if output_file:
        if output_file.endswith(".gif"):
            anim.save(output_file, writer="pillow", fps=fps)
        else:
            anim.save(output_file, writer="ffmpeg", fps=fps)
    plt.close(fig)
    return output_file

"""Point-stabilization reference trajectory with rotate-in-place phases
(twin of ``sicnav_tpu/mpc/ref_traj.py``).

The reference's ``point_stab`` reference, regenerated from the measured
state at every control step and cut to the first K stages:

  phase 1 (rotate in place, only when already within ``robot_radius`` of
      the goal): v = 0, |omega| >= max_rot toward the goal direction;
  phase 2 (cruise): v = pref_speed, heading servoed to point at the goal;
  phase 3 (arrival): one partial step v = dist/dt that lands exactly on the
      goal, then rotate in place toward the arrival heading.

The reference's ``lax.scan`` over the K stages is a loop of K steps here.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.ops.geometry import wrap_angle


def point_stab_reference(pos, theta, goal, K: int, dt: float,
                         pref_speed: float, max_rot: float, robot_radius):
    """Roll the multi-phase unicycle reference K steps from (pos, theta).

    Returns (poses (K+1, 3) [x, y, theta], actions (K, 2) [v, omega]).
    """
    dpg0 = goal - pos
    dist0 = torch.sqrt((dpg0 * dpg0).sum())
    far0 = dist0 > 1e-5
    theta_enroute = torch.where(far0, torch.atan2(dpg0[1], dpg0[0]), theta)

    # steps of the initial rotate-in-place phase (only when the robot is
    # already within its own radius of the goal) and of the cruise phase
    init_angle = torch.abs(wrap_angle(theta_enroute - theta))
    n_init = torch.where(dist0 > robot_radius, torch.zeros_like(dist0),
                         torch.ceil(init_angle / (dt * max_rot))
                         ).to(torch.int32)
    n_req = n_init + torch.ceil(dist0 / (dt * pref_speed)).to(torch.int32)

    x, y, th = pos[0], pos[1], theta
    poses, actions = [torch.stack([x, y, th])], []
    for idx in range(1, K + 1):
        dpg_x = goal[0] - x
        dpg_y = goal[1] - y
        dist = torch.sqrt(dpg_x ** 2 + dpg_y ** 2)
        far = (torch.abs(dpg_x) > 1e-5) | (torch.abs(dpg_y) > 1e-5)
        target = torch.where(far, torch.atan2(dpg_y, dpg_x), theta_enroute)
        dth = wrap_angle(target - th)

        cruise = (n_req > idx) & (n_init < idx)
        arrive = n_req == idx
        v = torch.where(cruise, torch.full_like(dist, pref_speed),
                        torch.where(arrive, dist / dt, torch.zeros_like(dist)))
        # rotate in place: at least max_rot toward the target heading
        dth_rot = torch.where(dth > 0.0, torch.clamp(dth, min=max_rot * dt),
                              torch.clamp(dth, max=-max_rot * dt))
        om = torch.where(cruise | arrive, dth / dt, dth_rot / dt)

        th = wrap_angle(th + dt * om)
        x = x + dt * v * torch.cos(th)
        y = y + dt * v * torch.sin(th)
        poses.append(torch.stack([x, y, th]))
        actions.append(torch.stack([v, om]))
    return torch.stack(poses), torch.stack(actions)

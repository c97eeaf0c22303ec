"""Real-robot streaming control loop (twin of ``sicnav_tpu/realtime.py``).

SICNav-Diffusion's ``select_action`` driven from asynchronous sensors:
observation callbacks push timestamped poses at any rate; each control
tick resamples the histories onto the model's dt grid (origin at the last
observation, linear interpolation), rebuilds the simulator and forecaster
states, and runs one fused control step.

Static obstacles are runtime parameters of the OCP, so
``set_static_obstacles`` retargets the controller without rebuilding it.

A tick makes one host-to-device copy: the observation is packed into one
pinned float32 host buffer, copied to the card at once, and split into the
state's tensors there.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from portbench.reference.frozen.device import resolve_device
from portbench.reference.frozen.diffusion import forecaster as FC
from portbench.reference.frozen.env.crowd_sim import tree_leaves, tree_unflatten
from portbench.reference.frozen.env.types import DoorParams, EnvConfig, SimState
from portbench.reference.frozen.mpc import ipm
from portbench.reference.frozen.mpc import sicnav_diffusion as SD

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


class ObservationBuffer:
    """Thread-safe asynchronous observation intake.

    ``push`` may be called from sensor callbacks at any rate; ``resample``
    (from the control thread) interpolates every channel linearly onto a dt
    grid that ends at the last observation.
    """

    def __init__(self, max_humans: int, maxlen: int = 600):
        self.lock = threading.Lock()
        self.max_humans = max_humans
        self.maxlen = maxlen
        self.t = []           # float timestamps (monotone)
        self.robot = []       # (x, y, theta)
        self.humans = []      # (H, 2) arrays

    def push(self, t_stamp: float, robot_pose, human_positions):
        """robot_pose: (x, y, theta); human_positions: (H, 2)."""
        hp = np.zeros((self.max_humans, 2), np.float64)
        hp_in = np.asarray(human_positions, np.float64)
        n = min(hp_in.shape[0], self.max_humans)
        hp[:n] = hp_in[:n]
        with self.lock:
            self.t.append(float(t_stamp))
            self.robot.append(np.asarray(robot_pose, np.float64))
            self.humans.append(hp)
            if len(self.t) > self.maxlen:
                self.t.pop(0)
                self.robot.pop(0)
                self.humans.pop(0)

    def resample(self, dt: float, n_frames: int):
        """Interpolate onto the grid t_last - dt * (n_frames - 1 .. 0).

        Returns (grid times (n,), robot (n, 3), humans (H, n, 2), covered):
        ``covered`` counts the grid points inside the observed time span
        (the rest take the earliest observation)."""
        with self.lock:
            if not self.t:
                raise RuntimeError("no observations received yet")
            t = np.asarray(self.t)
            robot = np.stack(self.robot)              # (N, 3)
            humans = np.stack(self.humans)            # (N, H, 2)
        grid = t[-1] - dt * np.arange(n_frames - 1, -1, -1)
        # unwrap the heading before interpolating it
        robot = robot.copy()
        robot[:, 2] = np.unwrap(robot[:, 2])
        rob_g = np.stack([np.interp(grid, t, robot[:, d]) for d in range(3)],
                         axis=-1)
        H = humans.shape[1]
        hum_g = np.stack(
            [np.stack([np.interp(grid, t, humans[:, h, d]) for d in range(2)],
                      axis=-1) for h in range(H)])    # (H, n, 2)
        covered = int(np.sum(grid >= t[0] - 1e-9))
        return grid, rob_g, hum_g, covered


class StreamingController:
    """Asynchronous-sensor SICNav-Diffusion controller.

    Usage (a 10 Hz robot loop):
      ctl = StreamingController(env_cfg, model)
      ctl.set_goal((gx, gy)); ctl.set_static_obstacles(segments)
      sensor thread:  ctl.observe(t, (x, y, th), human_xy)
      control thread: v, om, diag = ctl.select_action()

    ``model`` is a ``JMIDModel`` holding its weights, on ``device`` (CUDA
    unless named).
    """

    def __init__(self, env_cfg: EnvConfig, model, fcfg=None, settings=None,
                 ral: bool = True, num_stat_obs: Optional[int] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env_cfg = env_cfg
        if fcfg is None:
            fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                       dt=env_cfg.dt)
        self.fcfg = fcfg
        self.ocp, _ = SD.make_policy(env_cfg, model, fcfg=fcfg,
                                     settings=settings, ral=ral,
                                     device=self.device)
        if settings is None:
            settings = ipm.realtime_settings(self.ocp.cfg.num_hums,
                                             with_mid=True)
        self.model, self.settings = model, settings
        self.W = self.ocp.cfg.num_walls if num_stat_obs is None \
            else num_stat_obs
        self.buffer = ObservationBuffer(env_cfg.max_humans)
        self.carry = SD.init_carry(self.ocp, env_cfg.max_humans, fcfg, seed)
        self.goal = np.zeros(2)
        self.walls = np.zeros((env_cfg.wall_slots, 2, 2), np.float32)
        self.wall_mask = np.zeros((env_cfg.wall_slots,), bool)
        self._prev_cmd = np.zeros(2)
        self._have_prev = False
        self._step_idx = 0
        self._layout = None
        self._host = None

    # -- intake -----------------------------------------------------------

    def observe(self, t_stamp, robot_pose, human_positions):
        self.buffer.push(t_stamp, robot_pose, human_positions)

    def set_goal(self, goal):
        self.goal = np.asarray(goal, np.float64)

    def set_static_obstacles(self, segments):
        """segments: (n, 2, 2) wall end points, runtime OCP parameters."""
        seg = np.asarray(segments, np.float32).reshape(-1, 2, 2)
        W = self.env_cfg.wall_slots
        self.walls = np.zeros((W, 2, 2), np.float32)
        self.wall_mask = np.zeros((W,), bool)
        n = min(seg.shape[0], W)
        self.walls[:n] = seg[:n]
        self.wall_mask[:n] = True

    # -- control ----------------------------------------------------------

    def _build_state(self):
        """(SimState, ForecasterState) of numpy arrays from the resampled
        stream."""
        cfg, fcfg = self.env_cfg, self.fcfg
        grid, rob, hums, covered = self.buffer.resample(
            fcfg.dt, fcfg.past_frames)
        H = cfg.max_humans
        h_pos = hums[:, -1].astype(np.float32)
        h_vel = ((hums[:, -1] - hums[:, -2]) / fcfg.dt).astype(np.float32) \
            if fcfg.past_frames > 1 and covered > 1 else np.zeros((H, 2),
                                                                  np.float32)
        r_pos = rob[-1, :2].astype(np.float32)
        r_theta = np.float32(np.mod(rob[-1, 2] + np.pi, 2 * np.pi) - np.pi)
        r_vel = ((rob[-1, :2] - rob[-2, :2]) / fcfg.dt).astype(np.float32) \
            if covered > 1 else np.zeros(2, np.float32)
        r_omega = np.float32((rob[-1, 2] - rob[-2, 2]) / fcfg.dt) \
            if covered > 1 else np.float32(0.0)
        zH = np.zeros(H, np.float32)
        door = DoorParams(np.asarray(False), *(np.float32(0.0)
                                               for _ in range(6)))
        state = SimState(
            r_pos=r_pos, r_vel=r_vel, r_theta=r_theta, r_omega=r_omega,
            r_goal=self.goal.astype(np.float32),
            r_radius=np.float32(cfg.robot_radius),
            r_v_pref=np.float32(cfg.robot_v_pref),
            h_pos=h_pos, h_vel=h_vel,
            h_theta=np.arctan2(h_vel[:, 1], h_vel[:, 0]).astype(np.float32),
            h_goal=h_pos + 2.0 * h_vel, h_final_goal=h_pos + 2.0 * h_vel,
            h_radius=np.full(H, cfg.human_radius, np.float32),
            h_v_pref=np.full(H, cfg.human_v_pref, np.float32),
            h_mask=np.ones(H, bool),
            walls=self.walls, wall_mask=self.wall_mask, door=door,
            t=np.float32(grid[-1]), step_idx=np.int32(self._step_idx),
            prev_dist_to_goal=np.float32(
                np.linalg.norm(r_pos - self.goal)),
            prev_ang=np.float32(self._prev_cmd[1]),
            has_prev_ang=np.asarray(self._have_prev),
            prev_lin=np.float32(self._prev_cmd[0]),
            has_prev_lin=np.asarray(self._have_prev),
            human_times=zH, done=np.asarray(False))
        # the forecaster's history from the resampled grid, shifted back one
        # frame: the control step pushes the current positions onto it
        # (update_state_hists), after which it equals the grid
        hist_pre = np.concatenate([hums[:, :1], hums[:, :-1]], axis=1)
        cnt = max(min(covered, fcfg.past_frames) - 1, 0)
        fstate = FC.ForecasterState(hist=hist_pre.astype(np.float32),
                                    count=np.full(H, cnt, np.int32))
        return state, fstate

    def _to_device(self, state, fstate):
        """The numpy (SimState, ForecasterState) as tensors on the device,
        through one float32 host buffer (pinned for a card) and one copy."""
        leaves = [np.asarray(x) for x in tree_leaves((state, fstate))]
        if self._layout is None:
            sizes = [x.size for x in leaves]
            offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
            self._layout = ([x.shape for x in leaves],
                            [_TORCH_DTYPES[x.dtype] for x in leaves], offs)
            self._host = torch.empty(
                offs[-1], dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
        shapes, dtypes, offs = self._layout
        host = self._host.numpy()
        for x, o, o2 in zip(leaves, offs[:-1], offs[1:]):
            host[o:o2] = x.ravel()
        flat = (self._host.to(self.device, non_blocking=True)
                if self.device.type == "cuda" else self._host.clone())
        pieces = (flat[o:o2].reshape(sh).to(dt) for sh, dt, o, o2 in
                  zip(shapes, dtypes, offs[:-1], offs[1:]))
        return tree_unflatten((state, fstate), pieces)

    def select_action(self):
        """One streaming control step. Returns (v, omega, diag)."""
        t0 = time.perf_counter()
        state_np, fstate_np = self._build_state()
        state, fstate = self._to_device(state_np, fstate_np)
        # the history comes from the resample, not the carry's ring
        carry = self.carry._replace(forecaster=fstate)
        action, self.carry = SD.sicnav_diffusion_action(
            self.ocp, self.model, state, carry, self.env_cfg, self.fcfg,
            self.settings)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        action = action.cpu().numpy()
        latency = time.perf_counter() - t0
        self._prev_cmd = action
        self._have_prev = True
        self._step_idx += 1
        v, r = float(action[0]), float(action[1])
        return v, r / self.env_cfg.dt, {"latency_s": latency,
                                        "t_obs": float(state_np.t)}

"""Scene data for the JMID predictor (twin of
``sicnav_tpu/diffusion/data.py``).

Scenes are (A, T, 2) position tracks with validity masks, sliced into
fixed-shape training examples (history [pos, vel, acc], future velocities,
neighbour masks, rotation augmentation), from sim rollouts or ETH/UCY-style
text files. Dataset construction stays in numpy, as in the reference, so
the port builds the same examples bit for bit; ``SceneBatch.to_tensors``
moves a (stacked) example to the device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

ATTENTION_RADIUS = 3.0


def derivative_of(x, dt):
    """Finite-difference derivative over the last axis with the first
    element repeated, of a numpy array or a tensor."""
    if isinstance(x, np.ndarray):
        if x.shape[-1] < 2:
            return np.zeros_like(x)
        dx = np.diff(x, axis=-1) / dt
        return np.concatenate([dx[..., :1], dx], axis=-1)
    if x.shape[-1] < 2:
        return torch.zeros_like(x)
    dx = torch.diff(x, dim=-1) / dt
    return torch.cat([dx[..., :1], dx], dim=-1)


class SceneBatch(NamedTuple):
    """One scene at one prediction timestep, as numpy arrays (dataset
    construction) or tensors (the model's input); leading scene axes once
    stacked.

    hist: (A, T_h, 6) raw [px, py, vx, vy, ax, ay]
    hist_mask: (A, T_h) frames that exist
    fut_vel: (A, T_f, 2) raw future velocities (diffusion target)
    fut_mask: (A, T_f)
    agent_mask: (A,) agents present at the prediction time
    neighbor_mask: (A, A) [target, neighbour] adjacency (attention radius)
    node_type: (A,) int32 class codes into NODE_TYPES; None = all
        pedestrians
    """
    hist: np.ndarray
    hist_mask: np.ndarray
    fut_vel: np.ndarray
    fut_mask: np.ndarray
    agent_mask: np.ndarray
    neighbor_mask: np.ndarray
    node_type: np.ndarray = None

    def types(self):
        """node_type, defaulting to all-PEDESTRIAN for batches from
        single-class sources."""
        if self.node_type is not None:
            return self.node_type
        if isinstance(self.agent_mask, np.ndarray):
            return np.zeros(self.agent_mask.shape, np.int32)
        return torch.zeros(self.agent_mask.shape, dtype=torch.int32,
                           device=self.agent_mask.device)

    def to_tensors(self, device=None) -> "SceneBatch":
        """The same batch as tensors on ``device`` (float32 features, bool
        masks, int32 node types; None stays None)."""
        return SceneBatch(*[None if x is None else
                            torch.as_tensor(x, device=device) for x in self])


def tracks_to_state(pos, valid, dt):
    """(A, T, 2) positions -> (A, T, 6) [pos, vel, acc] via finite diff."""
    vel = np.stack([derivative_of(pos[..., 0], dt),
                    derivative_of(pos[..., 1], dt)], axis=-1)
    acc = np.stack([derivative_of(vel[..., 0], dt),
                    derivative_of(vel[..., 1], dt)], axis=-1)
    state = np.concatenate([pos, vel, acc], axis=-1)
    return np.where(valid[..., None], state, 0.0)


def build_examples(pos, valid, dt, history_len=6, horizon=8, max_agents=None,
                   stride=1, types=None):
    """Slice a scene's tracks into per-timestep SceneBatch examples.

    pos: (A, T, 2); valid: (A, T) bool; types: (A,) int class codes into
    NODE_TYPES (None = all PEDESTRIAN).
    """
    A, T, _ = pos.shape
    if types is None:
        types = np.zeros((A,), np.int32)
    if max_agents is None:
        max_agents = A
    state = tracks_to_state(pos, valid, dt)
    out = []
    for t in range(history_len - 1, T - horizon, stride):
        h_sl = slice(t - history_len + 1, t + 1)
        f_sl = slice(t + 1, t + 1 + horizon)
        agent_mask = valid[:, t].copy()
        if agent_mask.sum() == 0:
            continue
        if A > max_agents:
            # compact: agents PRESENT at t first (ETH-style files carry
            # every track id of the sequence; a naive [:max_agents] slice
            # would drop the active agents of later windows — the
            # reference gathers present nodes per timestep,
            # preprocessing.get_timesteps_data:623)
            order = np.argsort(~agent_mask, kind="stable")[:max_agents]
        else:
            order = np.arange(A)
        A_w = order.shape[0]
        agent_mask = agent_mask[order]
        hist = state[order][:, h_sl]
        hist_mask = valid[order][:, h_sl]
        fut_vel = state[order][:, f_sl, 2:4]
        fut_mask = valid[order][:, f_sl]
        cur = pos[order][:, t]
        d = np.linalg.norm(cur[:, None] - cur[None, :], axis=-1)
        neighbor_mask = (d < ATTENTION_RADIUS) & agent_mask[:, None] & \
            agent_mask[None, :] & ~np.eye(A_w, dtype=bool)

        def pad(x, fill=0.0):
            if x.shape[0] >= max_agents:
                return x[:max_agents]
            padw = [(0, max_agents - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, padw, constant_values=fill)

        out.append(SceneBatch(
            hist=pad(hist).astype(np.float32),
            hist_mask=pad(hist_mask).astype(bool),
            fut_vel=pad(fut_vel).astype(np.float32),
            fut_mask=pad(fut_mask).astype(bool),
            agent_mask=pad(agent_mask).astype(bool),
            neighbor_mask=pad(pad(neighbor_mask).T).T.astype(bool),
            node_type=pad(types[order]).astype(np.int32)))
    return out


def rotate_scene(batch: SceneBatch, theta: float) -> SceneBatch:
    """Rotation augmentation (preprocessing.augment_scene:304)."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]], np.float32)

    def rot(x):
        return x @ R.T

    hist = batch.hist.copy()
    hist[..., 0:2] = rot(hist[..., 0:2])
    hist[..., 2:4] = rot(hist[..., 2:4])
    hist[..., 4:6] = rot(hist[..., 4:6])
    return batch._replace(hist=hist, fut_vel=rot(batch.fut_vel))


def stack_batches(examples: List[SceneBatch]) -> SceneBatch:
    # .types() materializes node_type for old single-class examples so a
    # mixed/None list still stacks to one dense (B, A) int32 array
    examples = [e._replace(node_type=e.types()) for e in examples]
    return SceneBatch(*[np.stack([getattr(e, f) for e in examples])
                        for f in SceneBatch._fields])


def scenes_from_env_rollout(traj_states, human_only=True):
    """Extract (A, T, 2) position tracks + validity from a stacked rollout
    SimState (time axis leading)."""
    pos = np.asarray(traj_states.h_pos)                     # (T, H, 2)
    mask = np.asarray(traj_states.h_mask)                   # (T, H)
    if not human_only:
        rpos = np.asarray(traj_states.r_pos)[:, None, :]
        pos = np.concatenate([pos, rpos], axis=1)
        mask = np.concatenate([mask, np.ones_like(mask[:, :1])], axis=1)
    return pos.transpose(1, 0, 2), mask.T


# node-type codes for multi-class sources (process_data.py:413-421: raw
# files carry PEDESTRIAN / BICYCLE / ROBOT tags; the reference maps ROBOT
# rows to env.NodeType.JRDB_ROBOT)
NODE_TYPES = ("PEDESTRIAN", "BICYCLE", "ROBOT")


def load_trajectory_file(path, dt=0.4, frame_divisor=10, center=True,
                         keep_classes=("PEDESTRIAN",), return_types=False):
    """Raw trajectory file -> (pos (A, T, 2), valid (A, T)[, types (A,)]).

    Handles the reference's raw formats (process_data.py:300-355):
    - ETH/UCY txt: tab/whitespace ``frame_id  track_id  x  y``
    - JRDB/class csv: ``frame_id, track_id, x, y, node_type`` (header row)
    - jrdb_bev_hst csv: ``frame_id, track_id, x, y, interpolated``
    frame_ids are divided by ``frame_divisor`` (10 for non-sim sources) and
    positions mean-centered per scene, matching the reference.

    ``keep_classes``: class tags to keep (multi-class parity,
    process_data.py:413-421) — pass None to keep every class. With
    ``return_types=True`` also returns the per-track NODE_TYPES index
    (unknown tags map to PEDESTRIAN, matching the reference's
    has_class_info=False fallback at :342-343).
    """
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f):
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            try:
                frame = float(parts[0])
            except ValueError:
                continue  # header row
            track = float(parts[1])
            x, y = float(parts[2]), float(parts[3])
            node_type = parts[4] if len(parts) > 4 else "PEDESTRIAN"
            is_numeric = node_type.replace(".", "").replace("-", "").isdigit()
            if is_numeric:  # jrdb_bev_hst 'interpolated' column, not a class
                node_type = "PEDESTRIAN"
            if keep_classes is not None and not is_numeric and \
                    node_type not in keep_classes:
                continue
            code = NODE_TYPES.index(node_type) if node_type in NODE_TYPES \
                else 0
            rows.append((int(frame), int(track), x, y, code))
    raw = np.array(rows, np.float64)
    if frame_divisor and frame_divisor > 1:
        raw[:, 0] = raw[:, 0] // frame_divisor
    if center:
        raw[:, 2] -= raw[:, 2].mean()
        raw[:, 3] -= raw[:, 3].mean()

    frames = np.unique(raw[:, 0]).astype(int)
    peds = np.unique(raw[:, 1]).astype(int)
    f_idx = {f: i for i, f in enumerate(frames)}
    p_idx = {p: i for i, p in enumerate(peds)}
    pos = np.zeros((len(peds), len(frames), 2), np.float32)
    valid = np.zeros((len(peds), len(frames)), bool)
    types = np.zeros((len(peds),), np.int32)
    for row in raw:
        i = p_idx[int(row[1])]
        j = f_idx[int(row[0])]
        pos[i, j] = row[2:4]
        valid[i, j] = True
        types[i] = int(row[4])
    if return_types:
        return pos, valid, types
    return pos, valid


def load_ethucy_txt(path, dt=0.4):
    """Back-compat alias (ETH/UCY raw txt)."""
    return load_trajectory_file(path, dt=dt, frame_divisor=1, center=False)

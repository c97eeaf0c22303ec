"""Training and evaluation metrics logging (twin of
``sicnav_tpu/utils/metrics.py``): an append-only JSONL stream of one dict
per step or epoch, optional tensorboard event files, and the per-episode
event rates of a suite's ``EpisodeStats``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics stream ``<log_dir>/<name>.jsonl``. With
    ``tensorboard=True`` it also writes tensorboard event files under
    ``<log_dir>/tb``, and raises if no writer package is installed."""

    def __init__(self, log_dir: str, name: str = "metrics",
                 tensorboard: bool = False):
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise RuntimeError(
                    "MetricsLogger(tensorboard=True) needs the tensorboard "
                    "package, which is not installed; the JSONL stream "
                    "needs nothing: pass tensorboard=False") from e
            self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "wall_s": round(time.time() - self.t0, 2)}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
            if self._tb is not None and isinstance(rec[k], float):
                self._tb.add_scalar(k, rec[k], int(step))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def episode_event_rates(stats) -> Dict[str, float]:
    """Per-episode event rates of an ``EpisodeStats`` (tensors or arrays
    with a leading episode axis): the share of episodes with each event and
    the mean per-step frequencies."""
    s = {k: _np(v) for k, v in stats._asdict().items()}
    steps = np.maximum(s["steps"].astype(np.float64), 1.0)
    return {
        "rate/success": float(np.mean(s["success"])),
        "rate/timeout": float(np.mean(s["timeout"])),
        "rate/collision": float(np.mean(s["collision_steps"] > 0)),
        "rate/wall_collision": float(np.mean(s["wall_collision_steps"] > 0)),
        "rate/frozen": float(np.mean(s["frozen_steps"] > 0)),
        "rate/danger": float(np.mean(s["danger_steps"] > 0)),
        "freq/collision_steps": float(np.mean(s["collision_steps"] / steps)),
        "freq/danger_steps": float(np.mean(s["danger_steps"] / steps)),
        "mean/nav_time": float(np.mean(s["nav_time"])),
        "mean/total_reward": float(np.mean(s["total_reward"])),
    }

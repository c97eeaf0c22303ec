"""ctypes bridge to the native C++ ORCA engine (twin of
``sicnav_tpu/native/orca_cpp.py``): a second oracle, on the host, for the
port's batched ORCA (``ops/orca.orca_velocity``).

``orca_native.cpp`` is the reference's source. It is built at first use by
``g++ -O3 -shared -fPIC -std=c++17`` into ``build/native/<hash>/`` beside
the package (a directory git ignores), keyed by a hash of the source and
the flags, written under a temporary name and renamed into place. A build
that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "orca_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
LIB_NAME = "liborca_native.so"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def build_library() -> Path:
    """Build the engine unless a build of the same source and flags exists;
    returns the library's path."""
    key = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_DIR / key.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The engine, built at first use, with its C signature set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.orca_step.argtypes = [
            f32p, f32p, f32p, f32p, f32p, ctypes.c_int,
            f32p, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, f32p]
        lib.orca_step.restype = None
        _lib = lib
    return _lib


def orca_step_native(pos, vel, rad, pref_vel, max_speed, walls=None,
                     neighbor_dist=10.0, max_neighbors=10, time_horizon=2.0,
                     time_horizon_obst=0.5, dt=0.25):
    """New ORCA velocities for all agents at once.

    pos, vel, pref_vel: (N, 2); rad, max_speed: (N,);
    walls: (W, 2, 2) or None. Returns (N, 2) float32.
    """
    lib = load_library()
    pos = np.ascontiguousarray(pos, np.float32)
    vel = np.ascontiguousarray(vel, np.float32)
    rad = np.ascontiguousarray(rad, np.float32)
    pref_vel = np.ascontiguousarray(pref_vel, np.float32)
    max_speed = np.ascontiguousarray(max_speed, np.float32)
    n = pos.shape[0]
    for name, x, shape in (("vel", vel, (n, 2)), ("rad", rad, (n,)),
                           ("pref_vel", pref_vel, (n, 2)),
                           ("max_speed", max_speed, (n,))):
        if x.shape != shape:
            raise ValueError(f"orca_step_native: {name} {x.shape}, "
                             f"expected {shape}")
    if walls is None or len(walls) == 0:
        walls_arr = np.zeros((0, 4), np.float32)
    else:
        walls_arr = np.ascontiguousarray(
            np.asarray(walls, np.float32).reshape(-1, 4))
    out = np.zeros((n, 2), np.float32)
    lib.orca_step(pos, vel, rad, pref_vel, max_speed, n,
                  walls_arr, walls_arr.shape[0],
                  np.float32(neighbor_dist), max_neighbors,
                  np.float32(time_horizon), np.float32(time_horizon_obst),
                  np.float32(dt), out)
    return out


def orca_step_torch(pos, vel, rad, pref_vel, max_speed, walls=None,
                    device=None):
    """``orca_step_native``'s step through the port's batched ORCA
    (``ops/orca.orca_velocity``, every agent acting at once, the others
    its neighbours) on ``device`` (CUDA unless named), at the default
    ``OrcaParams`` and 10 neighbours. Returns (N, 2) float32 numpy."""
    import torch

    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.ops import orca as O
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    P, V, R = t(pos), t(vel), t(rad)
    n = P.shape[0]
    if walls is None or len(walls) == 0:
        walls, wmask = np.zeros((1, 2, 2)), [False]
    else:
        wmask = [True] * len(walls)
    ep1, ep2, emask = O.walls_to_edges(
        t(walls), torch.as_tensor(wmask, device=device))
    out = O.orca_velocity(
        P, V, R, t(pref_vel), t(max_speed), P.expand(n, n, 2),
        V.expand(n, n, 2), R.expand(n, n),
        ~torch.eye(n, dtype=torch.bool, device=device),
        ep1.expand(n, *ep1.shape), ep2.expand(n, *ep2.shape),
        emask.expand(n, *emask.shape), O.OrcaParams())
    return out.cpu().numpy()

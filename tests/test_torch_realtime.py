"""Parity of the port's streaming controller (sicnav_tpu_torch.realtime)
with the JAX reference's (sicnav_tpu.realtime).

- ``ObservationBuffer.resample`` bit-equal to the reference's on the same
  pushes (irregular timestamps, a heading that wraps, fewer humans than
  slots, a full ring), and thread-safe under a writer thread (as
  tests/test_realtime.py checks the reference's).
- ``_build_state``: the SimState and ForecasterState the port builds from a
  stream equal the reference's field by field (the same numpy operations;
  values equal, dtypes as each side's device state holds them), at the
  first tick and after commands, with the goal and runtime walls set; the
  one host-to-device buffer gives back the same values.
- One ``select_action`` on the CPU with the trained weights
  (``weights/jmid_hallway.npz``, 48 samples, KDE top 10) at 3 IPM
  iterations: a finite command, the carry and step counter advanced.
- chip_smoke.py's observe phase, rehearsed on the CPU at a small size.
"""

import os
import pathlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu import realtime as RT_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch import realtime as RT
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion.mid import JMIDModel
from sicnav_tpu_torch.diffusion.models import ModelConfig
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.mpc import ipm

from tests.test_torch_env import port_cfg
from tests.test_torch_mpc_ocp import ENV

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights",
                       "jmid_hallway.npz")
WALLS = [[[-3.0, -1.0], [3.0, -1.0]], [[-3.0, 3.0], [3.0, 3.0]],
         [[-1.0, 0.0], [-0.4, 0.0]]]


def _pushes(seed, n=40, H=3):
    """(t, pose, humans) at irregular times; the heading wraps past pi."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.02, 0.09, n))
    out = []
    for k, tk in enumerate(t):
        pose = (0.1 * tk, -2.0 + 0.4 * tk, np.pi - 0.5 + 0.05 * k)
        pose = (pose[0], pose[1], np.mod(pose[2] + np.pi, 2 * np.pi) - np.pi)
        hums = (rng.normal(0, 1, (H, 2)) * 0.01 +
                np.array([[1.0 - 0.3 * tk, 1.0], [-1.0, 0.5 + 0.2 * tk],
                          [0.0, 2.0]])[:H])
        out.append((float(tk), pose, hums))
    return out


@pytest.mark.parametrize("n_frames,maxlen,H", [(6, 600, 3), (8, 25, 2)])
def test_resample_bit_equal(n_frames, maxlen, H):
    buf_ref = RT_ref.ObservationBuffer(3, maxlen=maxlen)
    buf = RT.ObservationBuffer(3, maxlen=maxlen)
    for tk, pose, hums in _pushes(H, H=H):
        buf_ref.push(tk, pose, hums)
        buf.push(tk, pose, hums)
        if len(buf.t) >= 2:
            for got, want in zip(buf.resample(0.25, n_frames),
                                 buf_ref.resample(0.25, n_frames)):
                np.testing.assert_array_equal(got, want)
    assert len(buf.t) == min(40, maxlen)
    with pytest.raises(RuntimeError, match="no observations"):
        RT.ObservationBuffer(3).resample(0.25, 6)


def test_buffer_thread_safety():
    buf = RT.ObservationBuffer(max_humans=3, maxlen=50)
    stop = threading.Event()
    errs = []

    def writer():
        t = 0.0
        while not stop.is_set():
            buf.push(t, (t, t, 0.0), np.zeros((3, 2)))
            t += 0.01

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        time.sleep(0.02)
        for _ in range(200):
            try:
                grid, rob, hums, covered = buf.resample(0.25, 6)
                assert rob.shape == (6, 3) and hums.shape == (3, 6, 2)
            except Exception as e:  # pragma: no cover
                errs.append(e)
    finally:
        stop.set()
        th.join(timeout=1)
    assert not errs


def _controllers(model=None, settings=None):
    ref = RT_ref.StreamingController(ENV, None, None)
    port = RT.StreamingController(port_cfg(ENV), model, settings=settings,
                                  device="cpu")
    for c in (ref, port):
        c.set_goal((0.3, 3.5))
        c.set_static_obstacles(WALLS)
    return ref, port


def _same_tree(got, want, where):
    for name, g, w in zip(want._fields, got, want):
        if isinstance(w, tuple):
            _same_tree(g, w, f"{where}.{name}")
            continue
        w_dev = np.asarray(jnp.asarray(w))      # as the reference's device
        g = np.asarray(g)
        assert g.dtype == w_dev.dtype, (where, name, g.dtype, w_dev.dtype)
        np.testing.assert_array_equal(g, w_dev, err_msg=f"{where}.{name}")


def test_build_state_matches_reference():
    ref, port = _controllers()
    stream = _pushes(7)
    for k, (tk, pose, hums) in enumerate(stream):
        ref.observe(tk, pose, hums)
        port.observe(tk, pose, hums)
        if k in (0, 1, 12, 39):
            if k == 12:
                for c in (ref, port):
                    c._prev_cmd = np.array([0.4, -0.07])
                    c._have_prev, c._step_idx = True, 5
            s_w, f_w = ref._build_state()
            s, f = port._build_state()
            _same_tree(s, s_w, f"state at push {k}")
            _same_tree(f, f_w, f"forecaster at push {k}")
            # the one host buffer gives the same values back, as tensors
            s_t, f_t = port._to_device(s, f)
            for got, want in zip(CS.tree_leaves((s_t, f_t)),
                                 CS.tree_leaves((s, f))):
                assert torch.is_tensor(got)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port.W == ref.W == 4


def test_select_action_on_cpu():
    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), device="cpu")
    model.load_state_dict(convert.load_npz(WEIGHTS))
    _, port = _controllers(model, ipm.IPMSettings(n_iter=3))
    assert port.fcfg == FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                            dt=0.25)
    for tk, pose, hums in _pushes(3):
        port.observe(tk, pose, hums)
    z0 = port.carry.mpc.z_prev.clone()
    v, om, diag = port.select_action()
    assert np.isfinite(v) and np.isfinite(om) and diag["latency_s"] > 0
    assert diag["t_obs"] == pytest.approx(_pushes(3)[-1][0], abs=1e-5)
    assert port._step_idx == 1 and port._have_prev
    assert bool(port.carry.mpc.has_prev)
    assert not torch.equal(port.carry.mpc.z_prev, z0)
    assert int(port.carry.forecaster.count.max()) == 6
    port.observe(_pushes(3)[-1][0] + 0.1, (0.0, 0.0, 1.0),
                 np.zeros((3, 2)))
    v2, om2, _ = port.select_action()
    assert np.isfinite(v2) and np.isfinite(om2) and port._step_idx == 2


def test_chip_smoke_observe_rehearsal():
    """chip_smoke.py's observe phase (plain SICNav-p and the fused
    controller under noise and the filter, their float64 gate, the debug
    report card against CPU, the streaming loop), at B = 2 for a step or
    two of 3 IPM iterations and a streaming tick or two, on the CPU."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sicnav_tpu_torch.ops import kde_cuda

    launches = chip_smoke.phase_observe(
        kde_cuda, device="cpu", n_episodes=2, plain_steps=2, fused_steps=1,
        n_iter=3, gate_cases=2, stream_s=0.2)
    assert launches == 0                  # CPU tensors take the plain version

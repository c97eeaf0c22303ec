"""The port's episode renderer (sicnav_tpu_torch/utils/render.py) against
the reference's (sicnav_tpu/utils/render.py): the same 4-step trajectory
with every overlay (MPC plan and guess, predicted humans, forecast fans
with their weights, the FOV wedge), rendered to .gif by both packages in
the world frame and in the robot's frame. The decoded frames must be
equal pixel for pixel (both go through the same matplotlib Agg and
pillow code on the same numbers; the robot-frame transform is the one
place the packages compute differently, in float32 within 1e-6). Without
matplotlib, ``render_episode`` raises an ImportError that names it.
Skips where matplotlib or pillow is missing."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")
Image = pytest.importorskip("PIL.Image")

from sicnav_tpu.env import crowd_sim as CS_ref  # noqa: E402
from sicnav_tpu.env.types import EnvConfig as EnvConfig_ref  # noqa: E402
from sicnav_tpu.utils import render as R_ref  # noqa: E402
from sicnav_tpu_torch.env.types import (DoorParams, EnvConfig,  # noqa: E402
                                        SimState)
from sicnav_tpu_torch.utils import render as R  # noqa: E402

T, K, KF, F = 4, 4, 3, 8


def _trajectory():
    """Four states of hallway-bottleneck case 0 under fixed actions, stacked
    on a time axis: the reference's (JAX) and the same arrays as the
    port's (CPU tensors)."""
    cfg = EnvConfig_ref(scenario="hallway_bottleneck", human_num=3,
                        max_humans=3, starts_moving=0)
    s = CS_ref.reset_host(cfg, case=0)
    states = [s]
    for a in ([0.5, 0.1], [0.6, -0.1], [0.7, 0.2]):
        s, _, _ = CS_ref.step(s, jnp.asarray(a, jnp.float32), cfg)
        states.append(s)
    ref = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    def t(x):
        return torch.as_tensor(np.array(x))
    port = SimState(door=DoorParams(*[t(x) for x in ref.door]),
                    **{k: t(getattr(ref, k)) for k in SimState._fields
                       if k != "door"})
    return ref, port


def _overlays():
    rng = np.random.default_rng(0)
    H = 3
    return dict(
        plans=rng.normal(size=(T, K + 1, 2)).astype(np.float32),
        guesses=rng.normal(size=(T, K + 1, 2)).astype(np.float32),
        human_plans=rng.normal(size=(T, H, K + 1, 2)).astype(np.float32),
        forecasts=rng.normal(size=(T, H, KF, F + 1, 2)).astype(np.float32),
        forecast_weights=rng.normal(size=(T, H, KF)).astype(np.float32))


def _frames(path):
    img = Image.open(path)
    out = []
    for i in range(img.n_frames):
        img.seek(i)
        out.append(np.asarray(img.convert("L"), np.int16))
    return np.stack(out)


@pytest.mark.parametrize("robocentric", [False, True],
                         ids=["world", "robot_frame"])
def test_frames_equal(tmp_path, robocentric):
    ref, port = _trajectory()
    ov = _overlays()
    kw = dict(robocentric=robocentric, fov_deg=120.0, **ov)
    a = str(tmp_path / "port.gif")
    b = str(tmp_path / "ref.gif")
    assert R.render_episode(port, EnvConfig(), a, **kw) == a
    R_ref.render_episode(ref, EnvConfig_ref(), b, **kw)
    got, want = _frames(a), _frames(b)
    assert got.shape == want.shape and got.shape[0] == T
    assert np.array_equal(got, want), np.abs(got - want).max()


def test_overlays_from_tensors(tmp_path):
    """Overlays may be tensors: the same frames as from numpy."""
    _, port = _trajectory()
    ov = _overlays()
    a, b = str(tmp_path / "np.gif"), str(tmp_path / "t.gif")
    R.render_episode(port, EnvConfig(), a, **ov)
    R.render_episode(port, EnvConfig(), b,
                     **{k: torch.as_tensor(v) for k, v in ov.items()})
    assert np.array_equal(_frames(a), _frames(b))


def test_missing_matplotlib_raises(monkeypatch, tmp_path):
    _, port = _trajectory()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        R.render_episode(port, EnvConfig(), str(tmp_path / "x.gif"))
    assert not (tmp_path / "x.gif").exists()

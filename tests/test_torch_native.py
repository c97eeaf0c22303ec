"""The port's native ORCA oracle (sicnav_tpu_torch.native), twin of
tests/test_native.py.

- The port builds the reference's C++ source with the same flags, so its
  ``orca_step_native`` equals the reference's bit for bit on the same
  inputs (40 crowds of 2-6 agents, 40 single agents among 1-3 walls).
- The port's batched torch ORCA (``ops/orca``, through
  ``orca_step_torch``) is held to the native engine at tests/test_native.py's
  tolerances: 2e-3 per agent, at most 2 of the 40 wall scenes over it.
- A build that fails raises with the compiler's output.
"""

import os
import sys

import numpy as np
import pytest

from sicnav_tpu.native import orca_cpp as R
from sicnav_tpu_torch.native import orca_cpp as N

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TOL = 2e-3


def scenes():
    import chip_smoke
    return chip_smoke.orca_scenes(np.random.default_rng(0))


def test_native_equals_the_reference_build():
    agents, walls = scenes()
    for scene in agents + walls:
        np.testing.assert_array_equal(N.orca_step_native(*scene),
                                      R.orca_step_native(*scene))


def test_torch_orca_against_native_agents():
    agents, _ = scenes()
    for scene in agents:
        got = N.orca_step_torch(*scene, device="cpu")
        want = N.orca_step_native(*scene)
        assert np.linalg.norm(got - want, axis=-1).max() < TOL


def test_torch_orca_against_native_walls():
    _, walls = scenes()
    bad = sum(np.linalg.norm(N.orca_step_torch(*scene, device="cpu") -
                             N.orca_step_native(*scene)) > TOL
              for scene in walls)
    assert bad <= 2, f"{bad}/40 mismatches"


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    monkeypatch.setattr(N, "SRC", src)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*error"):
        N.build_library()
    assert not list((tmp_path / "build").rglob("*.so"))

"""Ground rules of the PyTorch port, checked on its source.

- No file of ``sicnav_tpu_torch/``, not ``chip_smoke.py`` and not the
  kernel tests (``tests/test_torch_kde_kernel.py``, run on the card) import
  JAX, Flax, Optax, Orbax or the JAX package: the card's machine has none
  of them.
- Kernels build with plain nvcc and bind with ctypes: no source includes
  PyTorch's extension header or uses ``torch.utils.cpp_extension``.
- The package carries source only: no file over 200 KB, no built library.
- Entry points run on CUDA unless told otherwise, and without a card they
  raise instead of running on the CPU.
"""

import ast
import pathlib

import pytest
import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import types as T

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sicnav_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sicnav_tpu"}
PY_FILES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kde_kernel.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom sicnav_tpu.ops import orca\n")
    assert _imported_roots(bad) & FORBIDDEN == {"sicnav_tpu"}


def test_kernels_build_without_torch_headers():
    sources = list((PKG / "csrc").glob("*.cu*")) + list(PKG.rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert any(p.suffix == ".cu" for p in sources)
    for p in sources:
        text = p.read_text()
        assert "torch/extension.h" not in text, p
        assert "cpp_extension" not in text, p


def test_package_holds_source_only():
    for p in PKG.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert p.suffix in {".py", ".cu", ".cuh"}, p
            assert p.stat().st_size < 200 * 1024, p


def test_entry_points_default_to_cuda():
    cfg = T.EnvConfig()
    calls = [
        lambda: CS.reset_host(cfg, 0),
        lambda: FC.init_state(cfg.max_humans, FC.ForecasterConfig()),
        lambda: MID.JMIDModel(M.ModelConfig(context_dim=8, enc_rnn_dim=4,
                                            tf_layer=1)),
    ]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

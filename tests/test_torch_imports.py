"""Ground rules of the PyTorch port, checked on its source.

- No file of ``sicnav_tpu_torch/``, not ``chip_smoke.py``, not the port's
  scripts and not the kernel tests (``tests/test_torch_kde_kernel.py``, run
  on the card) import JAX, Flax, Optax, Orbax or the JAX package: the
  card's machine has none of them.
- Kernels build with plain nvcc and bind with ctypes: no source includes
  PyTorch's extension header or uses ``torch.utils.cpp_extension``.
- The package carries source only: no file over 200 KB, no built library.
- Entry points run on CUDA unless told otherwise, and without a card they
  raise instead of running on the CPU.
"""

import ast
import pathlib
import sys

import pytest
import torch

from sicnav_tpu_torch.device import resolve_device
from sicnav_tpu_torch.diffusion import forecaster as FC
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.diffusion import trajectron as TJ
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import types as T
from sicnav_tpu_torch.mpc import campc as C
from sicnav_tpu_torch.mpc import ocp as OCP
from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sicnav_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sicnav_tpu"}
SCRIPTS = [ROOT / "scripts" / name for name in (
    "eval_suite_torch.py", "train_jmid_torch.py", "eval_prediction_torch.py",
    "train_rl_torch.py", "synthesize_ethucy_torch.py",
    "process_data_torch.py", "real_robot_loop_torch.py",
    "simple_test_torch.py", "eval_sicnav_diffusion_torch.py",
    "bench_control_step_torch.py", "audit_common_torch.py",
    "collision_taxonomy_torch.py", "timeout_taxonomy_torch.py",
    "suite_audit_torch.py", "sweep_ipm_iters_torch.py",
    "summarize_progress_torch.py", "eval_dispatch_paired_torch.py",
    "bench_fleet_scaling_torch.py")]
# the reference's script modules, which the port's scripts keep twins of
REFERENCE_SCRIPTS = {"audit_common", "collision_taxonomy",
                     "timeout_taxonomy", "eval_suite", "train_jmid",
                     "simple_test", "bench_control_step", "suite_audit"}
# imported only inside the function that needs it, never at import time
CALL_TIME_ONLY = {"dill"}
PY_FILES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kde_kernel.py"] + \
    SCRIPTS
sys.path.insert(0, str(ROOT / "scripts"))


def _imported_roots(path, module_level=False):
    """The top-level packages ``path`` imports (with ``module_level``, only
    those imported outside any function)."""
    tree = ast.parse(path.read_text(), str(path))
    nodes = _outside_functions(tree) if module_level else ast.walk(tree)
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _outside_functions(node):
    """``node`` and its descendants, not entering function bodies."""
    yield node
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
            yield from _outside_functions(child)


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & FORBIDDEN
    assert not _imported_roots(path, module_level=True) & CALL_TIME_ONLY


def test_scan_covers_the_mid_family():
    """The MID family's modules and scripts are among the files scanned,
    and dill is imported inside env_pkl's functions only."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("recipes", "trajectron", "env_pkl"):
        assert f"sicnav_tpu_torch/diffusion/{name}.py" in scanned, name
    for name in ("synthesize_ethucy_torch", "process_data_torch"):
        assert f"scripts/{name}.py" in scanned, name
    env_pkl = PKG / "diffusion" / "env_pkl.py"
    assert "dill" in _imported_roots(env_pkl)
    assert "dill" not in _imported_roots(env_pkl, module_level=True)


def test_scan_covers_the_mpc():
    """The controller's modules are among the files scanned."""
    scanned = {p.relative_to(PKG).as_posix() for p in PY_FILES
               if PKG in p.parents}
    for name in ("orca_lines", "ref_traj", "ocp", "ipm", "warmstart",
                 "campc", "sicnav_diffusion"):
        assert f"mpc/{name}.py" in scanned, name


def test_scan_covers_training_and_evaluation():
    """The training slice's modules and scripts are among the files
    scanned."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("policies/orca_robot", "env/scenarios", "env/crowd_sim",
                 "diffusion/data", "diffusion/diffusion", "diffusion/models",
                 "diffusion/mid", "diffusion/evaluation",
                 "diffusion/baselines", "utils/metrics", "convert"):
        assert f"sicnav_tpu_torch/{name}.py" in scanned, name
    for p in SCRIPTS:
        assert p.exists() and p.relative_to(ROOT).as_posix() in scanned


def test_scan_covers_rl():
    """The RL slice's modules are among the files scanned."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("rl/networks", "rl/dqn", "rl/imitation",
                 "env/human_policies"):
        assert f"sicnav_tpu_torch/{name}.py" in scanned, name
    assert "scripts/train_rl_torch.py" in scanned


def test_scan_covers_the_observation_path():
    """The observation path, the solver's introspection, the streaming
    controller and its script are among the files scanned."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("utils/robustness", "utils/state_filter",
                 "mpc/introspection", "realtime"):
        assert f"sicnav_tpu_torch/{name}.py" in scanned, name
    assert "scripts/real_robot_loop_torch.py" in scanned


def test_scan_covers_the_tools_slice():
    """The configs, occlusion, rendering and the analysis scripts are among
    the files scanned, and no port script imports a reference script."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("config", "env/occlusion", "utils/render"):
        assert f"sicnav_tpu_torch/{name}.py" in scanned, name
    for name in ("simple_test", "eval_sicnav_diffusion",
                 "bench_control_step", "audit_common", "collision_taxonomy",
                 "timeout_taxonomy", "suite_audit", "sweep_ipm_iters",
                 "summarize_progress", "eval_dispatch_paired"):
        assert f"scripts/{name}_torch.py" in scanned, name
    for p in SCRIPTS:
        assert not _imported_roots(p) & REFERENCE_SCRIPTS, p
    render = PKG / "utils" / "render.py"
    assert "matplotlib" in _imported_roots(render)
    assert "matplotlib" not in _imported_roots(render, module_level=True)


def test_scan_covers_the_mesh_slice():
    """The mesh, its users, the native oracle, the entry analog and the
    fleet bench are among the files scanned."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PY_FILES}
    for name in ("parallel/mesh", "parallel/fleet", "parallel/dryrun",
                 "native/orca_cpp", "entry"):
        assert f"sicnav_tpu_torch/{name}.py" in scanned, name
    assert "scripts/bench_fleet_scaling_torch.py" in scanned


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
            assert p.suffix in {".py", ".cu", ".cuh", ".cpp"}, p
            assert p.stat().st_size < 200 * 1024, p


def test_entry_points_default_to_cuda():
    from types import SimpleNamespace

    import bench_control_step_torch
    import bench_fleet_scaling_torch
    import collision_taxonomy_torch
    import eval_dispatch_paired_torch
    import eval_prediction_torch
    import eval_sicnav_diffusion_torch
    import eval_suite_torch
    import simple_test_torch
    import suite_audit_torch
    import sweep_ipm_iters_torch
    import timeout_taxonomy_torch
    import real_robot_loop_torch
    import synthesize_ethucy_torch
    import train_jmid_torch
    import train_rl_torch
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl import imitation as IL
    from sicnav_tpu_torch.rl import networks as N
    from sicnav_tpu_torch import entry
    from sicnav_tpu_torch.native import orca_cpp
    from sicnav_tpu_torch.parallel import dryrun, fleet
    from sicnav_tpu_torch.parallel import mesh as PM
    from sicnav_tpu_torch.realtime import StreamingController
    from sicnav_tpu_torch.utils.state_filter import init_filter
    cfg = T.EnvConfig()
    calls = [
        lambda: N.SARLNetwork(),
        lambda: N.RGLNetwork(),
        lambda: D.build_action_space(cfg, D.DQNConfig()),
        lambda: D.ReplayBuffer.create(4, 3),
        lambda: D.init_episode_rates(2),
        lambda: IL.collect_demonstrations(cfg, IL.ILConfig(), n_episodes=1),
        lambda: train_rl_torch.main([]),
        lambda: eval_suite_torch.main(["--policy", "orca_plus"]),
        lambda: CS.reset_device(cfg, 2),
        lambda: train_jmid_torch.generate_sim_scenes(2, cfg),
        lambda: train_jmid_torch.main([]),
        lambda: train_jmid_torch.main(["--method", "mid"]),
        lambda: eval_prediction_torch.main([]),
        lambda: eval_prediction_torch.main(["--method", "mid"]),
        lambda: synthesize_ethucy_torch.main(["--out", str(ROOT / "build" /
                                                            "never")]),
        lambda: TJ.CVAETrajectron(M.ModelConfig(context_dim=8, enc_rnn_dim=4,
                                                tf_layer=1)),
        lambda: CS.reset_host(cfg, 0),
        lambda: FC.init_state(cfg.max_humans, FC.ForecasterConfig()),
        lambda: MID.JMIDModel(M.ModelConfig(context_dim=8, enc_rnn_dim=4,
                                            tf_layer=1)),
        lambda: OCP.OCP(OCP.MPCConfig()),
        lambda: C.make_policy(cfg),
        lambda: SD.make_policy(cfg, None),
        lambda: C.make_policy(cfg, batch=True),
        lambda: init_filter(3, batch=2),
        lambda: StreamingController(cfg, None),
        lambda: real_robot_loop_torch.main([]),
        lambda: eval_suite_torch.main(["--policy", "campc"]),
        lambda: simple_test_torch.main(["--policy", "dwa"]),
        lambda: eval_sicnav_diffusion_torch.main([]),
        lambda: bench_control_step_torch.main([]),
        lambda: suite_audit_torch.main([]),
        lambda: collision_taxonomy_torch.main([]),
        lambda: timeout_taxonomy_torch.main([]),
        lambda: eval_dispatch_paired_torch.main([]),
        lambda: sweep_ipm_iters_torch.measure_latency(
            2, SimpleNamespace(device=None)),
        lambda: PM.make_mesh(),
        lambda: PM.plan(2),
        lambda: PM.launch(dryrun.main, 2),
        lambda: fleet.make_fleet_policy(cfg),
        lambda: entry.entry(),
        lambda: entry.dryrun_multichip(2),
        lambda: bench_fleet_scaling_torch.main([]),
        lambda: orca_cpp.orca_step_torch([[0.0, 0.0]], [[0.0, 0.0]], [0.3],
                                         [[1.0, 0.0]], [1.0]),
    ]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""A CPU rehearsal of ``chip_smoke.py``'s tools phase, as
``tests/test_torch_imid_phase.py`` rehearses its imid phase: the INI
configs, simple_test_torch.py's DWA episode from configs/env.config and
one debug step of the fused controller with the trained weights, the
traced suite audit of two cases (6 batched steps) and its resume, and
bench_control_step_torch.py's rows, at 2 IPM iterations and one call a
row. The CUDA-only checks (the kernel's launches, held against its plain
version on each input) run on the card; the card-only test below is the
phase at its full settings and skips here."""

import os
import pickle
import sys

import pytest
import torch

from sicnav_tpu_torch.ops import kde_cuda as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(2)


def test_chip_smoke_tools_rehearsal(tmp_path):
    import chip_smoke
    launches = chip_smoke.phase_tools(K, device="cpu", n_iter=2,
                                      debug_steps=1, bench_reps=1,
                                      out_dir=str(tmp_path))
    assert launches == 0           # CPU tensors take the plain version
    with open(tmp_path / "debug.pkl", "rb") as f:
        dbg = pickle.load(f)
    assert len(dbg["solves"]) == 1
    assert set(dbg["solves"][0]) == chip_smoke.DEBUG_KEYS
    assert sorted(os.listdir(tmp_path / "audit")) == ["batch_00000.npz"]
    assert (tmp_path / "dwa.pkl").exists()


@pytest.mark.gpu
def test_tools_phase_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this phase on "
                    "the card")
    import chip_smoke
    from sicnav_tpu_torch.ops import build
    build.build_library()
    build.load_library()
    launches = chip_smoke.phase_tools(K, out_dir=str(tmp_path))
    # debug steps, the audit's traced steps, the bench's forecast and
    # fused rows (a warm-up and the calls of each)
    assert launches == chip_smoke.TOOLS_DEBUG_STEPS + \
        int(chip_smoke.TOOLS_AUDIT_TIME / 0.25) + 2 + \
        2 * (chip_smoke.TOOLS_BENCH_REPS + 1)

"""A CPU rehearsal of ``chip_smoke.py``'s mesh phase, as
``tests/test_torch_tools_phase.py`` rehearses its tools phase: the native
ORCA oracle against the port's ORCA, ``entry()`` against itself on the
CPU, ``dryrun_multichip(2)``, the fused controller through
``harness.evaluate_policy(mesh=)`` on protocol cases 0-1 (one per rank)
held to the one-process run at batch 1, and the fleet bench at 1 and 2
ranks, all in gloo ranks on the CPU, at 2 control steps of 1 IPM
iteration. The CUDA-only checks (the kernel's launches, held against its
plain version on each input) run on the card; the card-only test below is
the phase at its full settings and skips here."""

import os
import sys

import pytest
import torch

from sicnav_tpu_torch.ops import kde_cuda as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(2)


def test_chip_smoke_mesh_rehearsal(tmp_path):
    import chip_smoke
    launches = chip_smoke.phase_mesh(K, device="cpu", n_iter=1,
                                     time_limit=0.0, n_cases=2,
                                     bench_batch=2, bench_iters=1,
                                     bench_reps=1, out_dir=str(tmp_path))
    assert launches == 0           # CPU tensors take the plain version
    assert sorted(os.listdir(tmp_path)) == ["mesh.jsonl", "one.jsonl"]


@pytest.mark.gpu
def test_mesh_phase_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this phase on "
                    "the card")
    import chip_smoke
    from sicnav_tpu_torch.ops import build
    build.build_library()
    build.load_library()
    launches = chip_smoke.phase_mesh(K, out_dir=str(tmp_path))
    # one launch per batched control step in each rank
    assert launches == chip_smoke.MESH_RANKS * (
        int(chip_smoke.MESH_TIME / 0.25) + 2)

"""The control on the card: the reference in the program's place at
float32 with TF32 on, at each cell's own size, comes out not correct on
three seeds. Run on the card as ``python3 -m pytest portbench/tests -q
-m gpu``; here it runs the control's path at a tiny size on the CPU,
where TF32 does not exist, so only that it runs is checked."""

import pytest
import torch

from portbench import run
from portbench.lib import registry

SEEDS = [1000000007, 2147483659, 3000000019]
CONTROL_SECONDS = {"sicnav_diffusion_hallway.eval_b10": 1.0,
                   "sicnav_diffusion_hallway.robot_b1": 11.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control is decided on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CONTROL_SECONDS))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, cell, seed):
    res = run.run_cell(cell, seed, CONTROL_SECONDS[cell], 0, card,
                       program="frozen")
    assert res["correct"] is False, res["checks"]


def test_control_path_runs_on_the_cpu():
    res = run.run_cell("sicnav_diffusion_hallway.eval_b10", 5, 0.1, 0,
                       torch.device("cpu"), program="frozen",
                       sizes={"batch": 2, "ipm": 2})
    assert set(res["checks"]) == set(
        registry.workload("sicnav_diffusion_hallway.eval_b10")["limits"])

"""The reference against the port at a tiny size on the CPU, through each
cell's own driver: a sound run comes out correct, and the run comes out
not correct with each fault the cell can have planted under its timed
path (a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced), in the env, the forecaster
and the controller. The look for a card is skipped; the sizes are cut
(batch, solver iterations)."""

import pytest
import torch

from portbench import run

TINY = {
    "sicnav_diffusion_hallway.eval_b10": {"batch": 2, "ipm": 2},
    "sicnav_diffusion_hallway.robot_b1": {"ipm": 2},
}
SECONDS = {"sicnav_diffusion_hallway.eval_b10": 0.1,
           "sicnav_diffusion_hallway.robot_b1": 3.0}
FAULTS = {
    "sicnav_diffusion_hallway.eval_b10": [
        "state_unchanged", "half_batch", "answer_altered",
        "mpc_carry_unchanged", "mpc_action_zero", "mpc_action_altered",
        "mpc_half_batch", "mpc_half_unsolved", "kde_altered"],
    "sicnav_diffusion_hallway.robot_b1": [
        "state_unchanged", "answer_altered", "mpc_carry_unchanged",
        "mpc_action_altered", "kde_altered"],
}
# a solve of two iterations moves too little for a start guess served
# as a solution to stand out
SIZES = {"mpc_half_unsolved": {"batch": 2, "ipm": 8}}
CASES = [(cell, None) for cell in TINY] + \
    [(cell, f) for cell, fs in FAULTS.items() for f in fs]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,fault", CASES)
def test_reference_decides_correct(cell, fault):
    res = run.run_cell(cell, 20261018, SECONDS[cell], 0, torch.device("cpu"),
                       fault=fault, sizes=SIZES.get(fault, TINY[cell]))
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is (fault is None), checks
    assert res["attempted"] > 0 and res["failed"] == 0


def test_traced_run_reports_span_metrics_on_the_cpu():
    cell = "sicnav_diffusion_hallway.eval_b10"
    res = run.run_cell(cell, 7, SECONDS[cell], 1, torch.device("cpu"),
                       sizes=TINY[cell])
    assert res["correct"] is True
    # spans are read here; device metrics need the card and are left out
    assert {"env_step_ms.eval", "forecast_ms.eval", "mpc_ms.eval",
            "mfu.eval"} <= set(res["metrics"])
    assert "idle_share.eval" not in res["metrics"]

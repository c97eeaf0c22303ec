"""The port's entry points (sicnav_tpu_torch.entry, twin of the
repository's ``__graft_entry__.py``) and the fleet bench
(scripts/bench_fleet_scaling_torch.py).

- ``entry()``: the same four scenes as the reference's, and its forward
  (the flagship JMID encoder and one denoiser evaluation per scene) from
  the reference entry's parameters carried over by
  ``convert.jmid_state_dict``, within 1e-4 of the reference's
  (tests/test_torch_jmid.py's tolerance for one network pass).
- ``dryrun_multichip(2, device="cpu")``: the four dryrun stages in two
  gloo ranks; ``python -m sicnav_tpu_torch.entry --device cpu`` prints
  ``entry ok`` and ``dryrun ok``.
- the bench at 1 and 2 ranks on a tiny fleet prints its rows and table.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

import __graft_entry__ as GE
from sicnav_tpu_torch import convert
from sicnav_tpu_torch import entry as E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def test_entry_matches_the_reference():
    fn_ref, (params, batch_ref) = GE.entry()
    want = np.asarray(jax.jit(fn_ref)(params, batch_ref))
    fn, (model, batch) = E.entry(device="cpu")
    for name in batch._fields:
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(batch_ref, name)),
                                      err_msg=name)
    own = fn(model, batch)
    assert own.shape == want.shape == (4, 4, 8, 2)
    assert torch.isfinite(own).all()
    model.load_state_dict(convert.jmid_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    np.testing.assert_allclose(fn(model, batch).numpy(), want, rtol=0,
                               atol=TOL)


def test_entry_module_runs_the_dryrun():
    """``python -m sicnav_tpu_torch.entry --device cpu``: the forward, then
    ``dryrun_multichip(2)``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "sicnav_tpu_torch.entry", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry ok (4, 4, 8, 2)")
    assert lines[1].startswith("dryrun ok") and "'size': 2" in lines[1]


def test_bench_fleet_scaling_prints_its_table(capsys):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_fleet_scaling_torch as BF
    assert BF.main(["--devices", "1", "2", "3", "--batch", "4", "--iters",
                    "2", "--reps", "1", "--num_humans", "2", "--device",
                    "cpu"]) == 0
    captured = capsys.readouterr()
    assert "skip 3 ranks" in captured.err
    out = captured.out
    rows = [json.loads(x) for x in out.splitlines()[:2]]
    table = json.loads(out[out.index('{\n'):])["table"]
    assert [r["devices"] for r in table] == [1, 2]
    for row, r in zip(rows, table):
        assert r == dict(row, speedup=r["speedup"])
        assert r["batch"] == 4 and r["backend"] == "gloo"
        assert np.isfinite(r["solves_per_s"]) and r["solves_per_s"] > 0
    assert table[0]["speedup"] == 1.0

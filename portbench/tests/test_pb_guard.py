"""The import guard compares top-level module names whole."""

import subprocess
import sys

from portbench.lib.guard import forbidden_modules

from conftest import ROOT


def test_whole_top_level_names():
    names = ["sicnav_tpu_torch", "sicnav_tpu_torch.mpc.ipm", "jaxtyping",
             "flaxen", "portbench.reference.frozen", "sicnav_tpu",
             "sicnav_tpu.env", "jax", "jax.numpy", "jaxlib.xla_client",
             "flax.linen"]
    assert forbidden_modules(names) == sorted(
        ["sicnav_tpu", "sicnav_tpu.env", "jax", "jax.numpy",
         "jaxlib.xla_client", "flax.linen"])


def test_the_harness_and_what_it_drives_load_no_jax():
    """Everything run.py loads for every cell, the port's modules and the
    frozen reference included, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.lib import guard, port, registry\n"
        "bench = registry.benchmark()\n"
        "for w in bench['workloads']:\n"
        "    registry.driver(registry.workload(w['name'])['driver'])\n"
        "for m in bench['per_layer']:\n"
        "    registry.metric_reader(m['name'])\n"
        "port.namespace('port'); port.namespace('frozen')\n"
        "import portbench.run, portbench.calibrate\n"
        "print(guard.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

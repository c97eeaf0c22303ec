"""Cells, configurations, drivers and per-layer metrics are found by
name; a new cell and a new metric are new files and entries only."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.lib import registry

BENCH = registry.benchmark()


def test_every_cell_has_its_files():
    names = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] in names
        registry.config(w["config"])
        assert hasattr(registry.driver(wl["driver"]), "run")
        for key in ("why", "limits"):
            assert key in wl


def test_every_metric_has_a_reader_and_a_reporting_cell():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert hasattr(registry.metric_reader(m["name"]), "read")
        for cell in m["workloads"]:
            assert cell in cells
            reported, _ = registry.cell_metrics(BENCH, cell)
            assert m["moves"] in {x["name"] for x in reported}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, layer = registry.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer


DRIVER = '''
import time

from portbench.lib.trace import TraceSummary


def run(ctx):
    tr = TraceSummary(1.0, 0.5, 2, 4, {"k": [4, 0.5]}, [("host", 0.1)])
    return {"t_window_start": time.perf_counter(),
            "attempted": 2, "failed": 0, "e2e": {"dummy_per_s": 2.0},
            "memory_peak_bytes": 0, "checks": [("dummy_gap", 0.0, 1.0)],
            "trace": tr, "layer": {"trace": tr}}
'''

READER = '''
from portbench.lib import layer


def read(data):
    return layer.idle_share(data)
'''


def test_a_new_cell_and_metric_are_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    driver and a per-layer metric as new files and new entries; every file
    that was there stays as it was, and the copy runs the new cell."""
    root = registry.ROOT
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy"}))
    (pb / "workloads" / "dummy.tiny.json").write_text(json.dumps(
        {"config": "dummy", "driver": "dummy", "why": "a test",
         "limits": {"dummy_gap": 1.0}}))
    (pb / "drivers" / "dummy.py").write_text(DRIVER)
    (pb / "metrics" / "idle_share.dummy.py").write_text(READER)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.tiny", "config": "dummy",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.tiny"]})
    bench["per_layer"].append({"name": "idle_share.dummy", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "Device", "moves": "dummy_per_s",
                               "workloads": ["dummy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    code = ("import sys, json, torch; sys.path.insert(0, %r)\n"
            "from portbench import run\n"
            "for t in (0, 1):\n"
            "    print(json.dumps(run.run_cell('dummy.tiny', 1, 1.0, t,\n"
            "                                  torch.device('cpu'))))\n"
            % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    plain, traced = (json.loads(x) for x in out.stdout.strip().splitlines())
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"dummy_per_s", "setup_s"}
    assert plain["metrics"]["dummy_per_s"]["value"] == 2.0
    assert traced["metrics"] == {"idle_share.dummy": {"value": 50.0,
                                                      "unit": "%"}}
    assert list(plain)[-1] == "checks"

"""Discovery by name: every cell, configuration, driver and per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it, so a later change adds files and entries and edits none.

- ``workloads/<cell>.json``: the cell's traffic and which driver runs it;
- ``configs/<config>.json``: the configuration, sizes as they are run;
- ``drivers/<driver>.py``: a module with ``run(ctx) -> dict``;
- ``metrics/<metric>.py``: a module with ``read(data) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # portbench/
ROOT = HERE.parent                                 # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def workload(name: str, base: Path = HERE) -> dict:
    return load_json(Path(base) / "workloads" / f"{name}.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(Path(base) / "configs" / f"{name}.json")


def load_module(path: Path, prefix: str):
    """Import the file at ``path`` under a module name made from its own
    (dots and dashes become underscores)."""
    path = Path(path)
    mod_name = prefix + re.sub(r"[^0-9A-Za-z_]", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    return load_module(Path(base) / "drivers" / f"{name}.py",
                       "portbench_driver_")


def metric_reader(name: str, base: Path = HERE):
    return load_module(Path(base) / "metrics" / f"{name}.py",
                       "portbench_metric_")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) of ``cell``: a metric with a
    ``workloads`` list belongs to the cells it lists; one without belongs
    to every cell, and a per-layer one without to every cell that reports
    the end-to-end metric it moves."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and ("workloads" in m or m["moves"] in names)]
    return e2e, layer

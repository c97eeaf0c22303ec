"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. With ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, the device's busy time
over a profiled window, and a breakdown of that window. Either way the
run checks what its timed path produced against the plain reference and
prints each compared number beside its limit, last on standard error and
last in the result line. The last line of standard output is the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# every build and kernel cache the program keeps sits at a fixed path
# inside the checkout (the port builds its kernels into build/kernels/)
CACHE = ROOT / "build" / "portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a driver gets: the cell, its configuration and the run's
    arguments. ``program`` is "port" (the system under test) or "frozen"
    (the reference's copy, TF32 on: the control); ``fault`` plants a fault
    under the timed path and ``sizes`` cuts the cell, for the harness's own
    tests only."""

    def __init__(self, cell, workload, config, seed, seconds, trace, device,
                 program="port", fault=None, sizes=None):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.seconds, self.trace = seed, seconds, bool(trace)
        self.device, self.program, self.fault = device, program, fault
        self.sizes = dict(sizes or {})

    def size(self, key, default):
        return self.sizes.get(key, default)

    def log(self, msg):
        log(msg)

    def memory_peak(self):
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def card_info(device):
    import torch
    kind = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "nvidia-smi not available"
    return kind, limit


def result_line(ctx, bench, out, t_start):
    """The result's JSON object from a driver's output."""
    from portbench.lib import registry
    e2e, layer = registry.cell_metrics(bench, ctx.cell)
    metrics = {}
    if not ctx.trace:
        values = dict(out["e2e"], setup_s=out["t_window_start"] - t_start)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        data = dict(out["layer"], cell=ctx.cell, workload=ctx.workload,
                    config=ctx.config)
        for m in layer:
            value = registry.metric_reader(m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = [c for c in out["checks"] if c[2] is not None]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) \
        and out["failed"] == 0
    res = {"correct": bool(correct), "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics}
    return res, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib import guard, registry
    bench = registry.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(args.workload, args.seed, args.seconds, args.trace,
                   device, bench=bench, t_start=T_START)
    if res is None:
        return 3
    print(json.dumps(res), flush=True)
    return 0


def _finite(x):
    """A number for the JSON line: a value that is not finite as a string."""
    return x if math.isfinite(x) else str(x)


def run_cell(cell, seed, seconds, trace, device, bench=None, t_start=None,
             program="port", fault=None, sizes=None):
    """Run ``cell`` once on ``device`` and return its result object (None
    when a forbidden module was loaded). The harness's tests call this
    directly, on the CPU and with ``sizes`` cut, skipping the look for a
    card; ``program`` and ``fault`` serve the control and those tests."""
    from portbench.lib import guard, registry
    bench = registry.benchmark() if bench is None else bench
    t_start = time.perf_counter() if t_start is None else t_start
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    wl = registry.workload(cell)
    cfg = registry.config(entry["config"])
    ctx = Context(cell, wl, cfg, seed, seconds, trace, device, program,
                  fault, sizes)
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    out = registry.driver(wl["driver"]).run(ctx)

    found = guard.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return None
    if device.type == "cuda":
        kind, limit = card_info(device)
        log(f"card: {kind}; power limit: {limit}")
    else:
        kind = "cpu"
    res, checks = result_line(ctx, bench, out, t_start)
    res["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": kind, "count": 1,
                     "memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.trace:
        tr = out["trace"]
        res["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        res["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    res["readings"] = {n: _finite(v) for n, v, lim in out["checks"]
                       if lim is None}
    res["checks"] = {n: {"value": _finite(v), "limit": lim}
                     for n, v, lim in checks}
    for n, v in res["readings"].items():
        log(f"not compared {n}: {v!r}")
    for n, v, lim in checks:
        log(f"check {n}: {v!r} (limit {lim!r})")
    return res


if __name__ == "__main__":
    sys.exit(main())

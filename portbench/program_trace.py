"""Run one cell once as ``run.py --trace 1`` runs it, with the program's
own tracer (``sicnav_tpu_torch.utils.tracing``) on, and print what the
tracer saw beside the cell's per-layer metrics.

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> [--tracer 0|1] [--out FILE]

from the root of a checkout, on a machine with the card. The cell's own
driver runs unchanged; this script only takes its hooks from outside:
the tracer is switched on before set-up, the set-up snapshot is taken
when the window starts, the window's snapshot just before the profiled
unit, and the profiled unit's own snapshot after it (the tracer is then
switched off). The profiled unit's kernels are attributed to the program
span each was launched in, and its idle gaps labelled with program
spans. The reference's check after the window is not run: ``correct`` is
``run.py``'s to decide. ``--tracer 0`` runs the same with the tracer
off, for its on-cost and for the device metrics with and without it.

The last line of standard output is one JSON object: the window's
end-to-end numbers (``e2e``), the cell's per-layer metrics (``layer``),
the program's (``program``), the controller by the program's spans
against ``mpc_ms`` (``mpc_by_spans``), the profiled unit's ``join`` and
the run's wall. ``--out`` also writes the window's and the profiled
unit's spans and counters.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402


# the metric family of a cell, by the driver its workload names: a cell
# whose driver is neither is refused
FAMILY = {"eval_loop": "eval", "robot_ticks": "robot"}


def family(wl):
    """The metric family ("eval" or "robot") of a workload."""
    try:
        return FAMILY[wl["driver"]]
    except KeyError:
        raise ValueError(f"no program metrics for the driver "
                         f"{wl.get('driver')!r}") from None


def trace_cell(cell, seed, seconds, tracer, device, sizes=None):
    """Run ``cell`` once, traced; returns (the JSON result, the
    snapshots). ``sizes`` cuts the cell, as for the harness's tests on the
    CPU."""
    import torch
    from portbench.lib import program, registry, trace
    from sicnav_tpu_torch.utils import tracing

    bench = registry.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    wl = registry.workload(cell)
    sfx = family(wl)
    cfg = registry.config(entry["config"])
    ctx = R.Context(cell, wl, cfg, seed, seconds, 1, device, sizes=sizes)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    drv = registry.driver(wl["driver"])
    snaps, joined = {}, {}

    class Window(drv.Window):
        def start(self):
            if tracer:
                snaps["setup"] = tracing.snapshot()
                tracing.reset()
            return super().start()

    def profile(fn, units, sync):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        if tracer:
            snaps["window"] = tracing.snapshot()
            tracing.reset()
        sync()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            window_s = time.perf_counter() - t0
        if tracer:
            snaps["unit"] = tracing.snapshot()
            tracing.disable()
            joined.update(program.join(prof, snaps["unit"]))
        return trace.reduce(prof, window_s, units)

    saved = (drv.Window, trace.profile, drv.check)
    drv.Window, trace.profile = Window, profile
    drv.check = lambda *args, **kwargs: []
    try:
        if tracer:
            tracing.enable(device)
        out = drv.run(ctx)
    finally:
        drv.Window, trace.profile, drv.check = saved
        tracing.disable()
    res, _ = R.result_line(ctx, bench, out, T_START)
    layer = {k: v["value"] for k, v in res["metrics"].items()}
    result = {"cell": cell, "seed": seed, "tracer": int(tracer),
              "e2e": out["e2e"], "layer": layer,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"],
                         "busy_s": out["trace"].busy_s,
                         "window_s": out["trace"].window_s}}
    if tracer:
        result["program"] = program.metrics(snaps.get("setup"),
                                            snaps.get("window"), sfx)
        parts = program.mpc_parts_ms(snaps["window"], sfx)
        if parts is not None:
            outside = layer.get(f"mpc_ms.{sfx}")
            result["mpc_by_spans"] = {
                "mpc_ms": outside, "program_mpc_ms": parts[0],
                "parts_ms": parts[1],
                "parts_over_mpc_ms": parts[1] / outside if outside else None}
        unit = program.metrics(None, snaps["unit"], sfx)
        result["profiled_unit"] = dict(unit, **joined)
        result["sync_sites"] = dict(list(
            snaps["window"].sync_sites.items())[:20])
    result["wall_s"] = time.perf_counter() - T_START
    return result, snaps


def _dump(snap):
    return {"clock_offset_ns": snap.clock_offset_ns,
            "sync_sites": snap.sync_sites,
            "spans": [list(s) for s in snap.spans],
            "counts": [list(c) for c in snap.counts]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        R.log("program_trace needs a CUDA card")
        return 2
    res, snaps = trace_cell(args.workload, args.seed, args.seconds,
                            bool(args.tracer), torch.device("cuda", 0))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(res, snapshots={k: _dump(v)
                                           for k, v in snaps.items()}), f)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

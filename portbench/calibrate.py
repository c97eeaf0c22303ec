"""Readings for the limits of a cell: the compared numbers of the
program over many seeds, of the control (``--control``: the frozen
reference in the program's place, one notch below the configuration's
precision, float32 with TF32 on for float32 with TF32 off), or of the
program with a fault planted (``--fault``), in one process so that each
seed pays no imports and no kernel build.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        [--control | --fault <name>] --seeds <n> [<n> ...]

(``--fault`` plants one of the faults of ``lib/record.plant``) and
prints one JSON line a seed: the seed, ``correct``, the compared numbers
and the end-to-end metrics. The benchmark's own runs never run it.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def _run_module():
    """``run.py`` as a module (this file runs as a script beside it)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_run", Path(__file__).resolve().parent / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant this fault under the timed path")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    run = _run_module()
    import torch
    if not torch.cuda.is_available():
        run.log("calibration runs on a CUDA card")
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.run_cell(args.workload, seed, args.seconds, 0, device,
                           program="frozen" if args.control else "port",
                           fault=args.fault)
        print(json.dumps({"seed": seed, "control": args.control,
                          "fault": args.fault,
                          "correct": res["correct"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()},
                          "readings": res["readings"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Summarize a (possibly partial) progress JSONL of the port's harness
into the evaluation suite's summary metrics (twin of
scripts/summarize_progress.py).

    python scripts/summarize_progress_torch.py build/accept.jsonl

``harness.evaluate_policy(progress_file=...)`` appends each finished
batch's episode stats; this reads that prefix back
(``harness._load_progress``) and prints the summary the finished run would
have printed over the cases that completed, with ``num_cases`` and the
batches it read. Reads no device; imports no JAX.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("progress_file")
    p.add_argument("--time_limit", type=float, default=30.0)
    p.add_argument("--scenario", default="hallway_bottleneck")
    args = p.parse_args(argv)

    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env.rollout import EpisodeStats
    from sicnav_tpu_torch.env.types import EnvConfig

    completed = harness._load_progress(args.progress_file)
    if not completed:
        print(json.dumps({"num_cases": 0}))
        return {"num_cases": 0}
    parts = [completed[k] for k in sorted(completed)]
    stats = EpisodeStats(*[np.concatenate([np.atleast_1d(x) for x in xs])
                           for xs in zip(*parts)])
    cfg = EnvConfig(scenario=args.scenario, time_limit=args.time_limit)
    out = harness.summarize(stats, cfg)
    out["num_cases"] = int(np.atleast_1d(stats.success).shape[0])
    out["batches"] = sorted(completed)
    out = {k: (v if isinstance(v, (int, list)) else float(v))
           for k, v in out.items()}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

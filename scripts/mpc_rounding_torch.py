#!/usr/bin/env python3
"""How far rounding alone moves the port's MPC control step.

    python scripts/mpc_rounding_torch.py [--step 2] [--threads 4 1]

Drives chip_smoke.py's main path (the definitive protocol with the trained
weights) on the CPU up to control step ``--step``, then reruns that step's
MPC (same state, carry and served forecasts) in float32 and in float64 at
each CPU thread count, which changes the reduction order of the BLAS and
LAPACK calls and nothing else. Prints each action and the largest
differences: between thread counts in each precision, and float32 against
float64. chip_smoke.py's cross-check bounds rest on these readings.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke
    from sicnav_tpu_torch.env.crowd_sim import tree_map
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
    from sicnav_tpu_torch.ops import kde_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--step", type=int, default=chip_smoke.CROSS_STEP)
    ap.add_argument("--threads", type=int, nargs="+", default=[4, 1])
    args = ap.parse_args()

    torch.set_num_threads(args.threads[0])
    ocp, _, settings, record, _ = chip_smoke.phase_mpc(
        kde_cuda, device="cpu", max_steps=args.step + 1)
    k, state, carry, (fc, lw) = record
    cfg = chip_smoke.protocol_env()
    actions = {}
    for dtype in (torch.float32, torch.float64):
        def cast(x):
            return x.to(dtype) if x.is_floating_point() else x
        for n in args.threads:
            torch.set_num_threads(n)
            a, _, aux = SD.act_on_forecasts(
                ocp, *(tree_map(cast, x) for x in (state, carry, fc, lw)),
                cfg, settings, aux=True)
            actions[(dtype, n)] = a.double()
            print(f"step {k} {dtype} {n} threads: action {a.tolist()} "
                  f"eq_viol {aux.eq_viol.item():.3e} "
                  f"guess {bool(aux.use_guess)}", flush=True)
    first, last = args.threads[0], args.threads[-1]
    for dtype in (torch.float32, torch.float64):
        d = (actions[(dtype, first)] - actions[(dtype, last)]).abs().max()
        print(f"{dtype}: {first} vs {last} threads, max abs diff "
              f"{d.item():.4e}")
    d = (actions[(torch.float32, first)] -
         actions[(torch.float64, first)]).abs().max()
    print(f"float32 vs float64 at {first} threads: max abs diff "
          f"{d.item():.4e}")


if __name__ == "__main__":
    main()

"""Solver-failure introspection: named constraint violations and
per-iteration solve traces (twin of ``sicnav_tpu/mpc/introspection.py``).

The reference's two debug systems: CAMPC's ``DO_DEBUG`` iterate log and
per-constraint violation tables, and SICNavAcados's argmax-violated
constraint printed by name after a failed solve. The constraint classes are
already grouped (``OCP._ineq_groups``), so the named report is a dict of
tensors a control step can return; formatting happens on the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from portbench.reference.frozen.mpc import ipm
from portbench.reference.frozen.mpc.ocp import OCP, MPCParams


class GroupViolation(NamedTuple):
    max_viol: torch.Tensor   # () max over the group's rows (0 if satisfied)
    arg_flat: torch.Tensor   # () int32 flat index of the worst row


class IterTrace(NamedTuple):
    """Per-IPM-iteration table (the reference's iterate log)."""
    obj: torch.Tensor        # (n_iter,)
    merit: torch.Tensor
    alpha: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    eq_viol: torch.Tensor
    ineq_viol: torch.Tensor
    kkt_stat: torch.Tensor   # gradient-scaled dual infeasibility
    kkt_comp: torch.Tensor   # gradient-scaled complementarity


def _group(rows) -> GroupViolation:
    flat = rows.reshape(-1)
    return GroupViolation(torch.amax(flat),
                          torch.argmax(flat).to(torch.int32))


def constraint_report(ocp: OCP, z, params: MPCParams
                      ) -> Dict[str, GroupViolation]:
    """Named per-class violations of the raw (not slack-shifted)
    constraints at z, keyed by the reference's constraint-class names in
    sorted order: the reference's reports come out of ``jax.jit``, which
    sorts a dict's keys, and ``argmax_violated`` breaks ties in that
    order."""
    report = {name: _group(torch.clamp(rows, min=0.0))
              for name, rows in ocp._ineq_groups(z, params).items()}
    if ocp.cfg.kkt:
        cfg = ocp.cfg
        res = ocp.eq_residuals(z, params).reshape(
            cfg.K_orca, cfg.num_hums, 3 + cfg.n_lam)
        report["kkt_stationarity"] = _group(torch.abs(res[:, :, :3]))
        report["kkt_complementarity"] = _group(torch.abs(res[:, :, 3:]))
    return dict(sorted(report.items()))


def argmax_violated(report: Dict[str, GroupViolation]):
    """Host side: (name, value, flat index) of the worst constraint
    class."""
    name, gv = max(report.items(), key=lambda kv: float(kv[1].max_viol))
    return name, float(gv.max_viol), int(gv.arg_flat)


def describe_row(ocp: OCP, name: str, flat_idx: int) -> str:
    """A group's flat row index as (stage, human / wall / row) text."""
    cfg = ocp.cfg
    K, Ko, H, W = cfg.K, cfg.K_orca, cfg.num_hums, cfg.num_walls
    shapes = {
        "coll": (K + 1, H), "stat": (W, K + 1), "bound": (2 * K * 2,),
        "acc": (K, 3), "maxvel": (K, H), "ksi": (K, H),
        "kkt": (Ko, H, 2 * cfg.n_lam), "preds": (K, H),
        "kkt_stationarity": (Ko, H, 3),
        "kkt_complementarity": (Ko, H, cfg.n_lam),
    }
    if name not in shapes:
        return f"{name}[{flat_idx}]"
    idx = np.unravel_index(flat_idx, shapes[name])
    labels = {
        "coll": ("k", "hum"), "stat": ("wall", "k"), "bound": ("row",),
        "acc": ("k", "row"), "maxvel": ("k", "hum"), "ksi": ("k", "hum"),
        "kkt": ("k", "hum", "row"), "preds": ("k", "hum"),
        "kkt_stationarity": ("k", "hum", "grad_row"),
        "kkt_complementarity": ("k", "hum", "lam_row"),
    }
    parts = ", ".join(f"{l}={i}" for l, i in zip(labels[name], idx))
    return f"{name}({parts})"


class SolveDebug(NamedTuple):
    """What the reference records per solve, as one NamedTuple a control
    step can return."""
    trace: IterTrace
    info: ipm.IPMInfo
    viol_sol: Dict[str, GroupViolation]    # at the raw IPM solution
    viol_used: Dict[str, GroupViolation]   # at the adopted plan
    used_guess: torch.Tensor               # bool: the cascade fell back
    sol_cost: torch.Tensor
    guess_cost: torch.Tensor
    slack_max: torch.Tensor                # max slack of the adopted plan
    plan: torch.Tensor                     # (K+1, 2) adopted robot plan
    guess_plan: torch.Tensor               # (K+1, 2) warmstart-guess plan
    human_plans: torch.Tensor              # (H, K+1, 2) predicted humans


def solve_with_debug(ocp: OCP, params: MPCParams, z_guess,
                     settings: ipm.IPMSettings):
    """One instrumented NLP solve: (z_sol, info, IterTrace), for audits of
    a frozen problem instance. The reference's (f, c_E, c_I) is the port's
    (f, ``ocp.residuals``)."""
    z_sol, info, raw = ipm.solve(lambda z: ocp.cost(z, params),
                                 lambda z: ocp.residuals(z, params), z_guess,
                                 settings, return_trace=True)
    return z_sol, info, IterTrace(*raw)


def debug_solve_report(ocp: OCP, params: MPCParams, z_guess,
                       settings: ipm.IPMSettings) -> dict:
    """Host-side audit of a frozen problem instance: the instrumented
    solve as plain-numpy tables and the worst constraint's name."""
    z_sol, info, trace = solve_with_debug(ocp, params, z_guess, settings)
    rep_guess = constraint_report(ocp, z_guess, params)
    rep_sol = constraint_report(ocp, z_sol, params)
    name, val, flat = argmax_violated(rep_sol)
    return {
        "iterations": {k: v.detach().cpu().numpy()
                       for k, v in trace._asdict().items()},
        "info": {k: float(v) for k, v in info._asdict().items()},
        "viol_guess": {k: float(v.max_viol) for k, v in rep_guess.items()},
        "viol_sol": {k: float(v.max_viol) for k, v in rep_sol.items()},
        "worst": {"name": name, "value": val,
                  "row": describe_row(ocp, name, flat)},
        "z_sol": z_sol.detach().cpu().numpy(),
    }

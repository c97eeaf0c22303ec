"""The numbers compared against each cell's limits.

Every number is the worst case over what it covers, so one bad episode,
agent or leaf is enough to fail it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _leaves(tree):
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, np.generic):
        return [np.asarray(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for leaf in tree for x in _leaves(leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for leaf in tree for x in _leaves(leaf)]
    return []


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_gap(a, b) -> float:
    """The largest absolute gap over the float leaves of two trees of the
    same layout; a boolean or integer leaf that differs, or a float leaf
    that is not finite on one side only, counts as infinite."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return math.inf
    worst = 0.0
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        if x.shape != y.shape:
            return math.inf
        if x.dtype.kind in "fc" or y.dtype.kind in "fc":
            x, y = x.astype(np.float64), y.astype(np.float64)
            fx, fy = np.isfinite(x), np.isfinite(y)
            if (fx != fy).any():
                return math.inf
            if fx.any():
                worst = max(worst, float(np.abs(x[fx] - y[fx]).max()))
        elif (x != y).any():
            return math.inf
    return worst


def joint_likelihood(kde_ops, geometry, samples):
    """The joint KDE ranking score of every sample, (B, S), as
    ``diffusion.kde.most_likely_samples`` ranks them: per horizon step a
    Gaussian KDE over the (humans x xy) sample space, normalized over the
    samples, summed over the horizon. ``samples`` (B, S, H, T, 2)."""
    B, S, H, T, _ = samples.shape
    preds = samples.movedim(-2, -4).reshape(-1, S, H * 2)
    bw = torch.exp(geometry.linspace(math.log(0.01), math.log(0.1), T,
                                     device=samples.device))
    ll = kde_ops.kde_loglik_fused(preds, bw.expand(B, T).reshape(-1))
    ll = ll.reshape(B, T, S)
    ll = ll - torch.logsumexp(ll, dim=-1, keepdim=True)
    return ll.sum(dim=-2)


def forecast_numbers(prog, ref_samples, ref_lik):
    """The forecaster's numbers for B episodes.

    ``prog``: the program's samples (B, S, H, T, 2) as it ranked them, and
    its ranking: the top k (B, H, k, T, 2) and their log-weights (B, H, k).
    ``ref_samples``: the reference's samples from the same noise; and
    ``ref_lik`` (B, S): the reference's scores of the samples the program
    ranked.

    - ``sample_gap``: the largest gap between the two sides' samples;
    - ``regret``: the program's ranking judged by the reference's scores:
      how far the best sample it left out scores above the worst it kept
      (0 when it kept the reference's top k). Samples that tie are
      interchangeable, so a tie broken the other way costs only the tie's
      width;
    - ``lw_gap``: how far its log-weights lie from the kept samples'
      scores normalized over them."""
    samples, top, lw = (x.double() for x in prog)
    ref_samples, ref_lik = ref_samples.double(), ref_lik.double()
    sample_gap = float((samples - ref_samples).abs().max())
    B, S = samples.shape[:2]
    k = top.shape[2]
    top_s = top.movedim(2, 1)                           # (B, k, H, T, 2)
    dist = (top_s[:, :, None] - samples[:, None]).abs().flatten(3).amax(-1)
    # each served forecast is a distinct sample; equal samples (humans all
    # outside the cluster get one constant-velocity forecast) match in turn
    kept = torch.zeros((B, S), dtype=torch.bool, device=samples.device)
    chosen = []
    for j in range(k):
        d = torch.where(kept, math.inf, dist[:, j])
        idx = d.argmin(dim=-1)
        if float(d.gather(1, idx[:, None]).max()) > 0.0:
            return sample_gap, math.inf, math.inf   # a forecast is no sample
        kept.scatter_(1, idx[:, None], True)
        chosen.append(idx)
    chosen = torch.stack(chosen, dim=1)                 # (B, k)
    inf = torch.tensor(math.inf, dtype=ref_lik.dtype, device=ref_lik.device)
    worst_kept = torch.where(kept, ref_lik, inf).amin(-1)
    best_left = torch.where(kept, -inf, ref_lik).amax(-1)
    regret = float(torch.clamp(best_left - worst_kept, min=0.0).max())
    kept_lik = torch.gather(ref_lik, 1, chosen)          # (B, k)
    want = kept_lik - torch.logsumexp(kept_lik, dim=-1, keepdim=True)
    lw_gap = float((lw - want[:, None, :]).abs().max())
    return sample_gap, regret, lw_gap


def _angle(x):
    return torch.atan2(torch.sin(x), torch.cos(x))


def controller_numbers(R, ocp, env_cfg, inp: dict, carry_ref=None):
    """The controller half of one episode's control step, judged in the
    reference's precision. ``inp``: the program's inputs (``state``,
    ``carry``, ``forecasts``, ``log_w``) and outputs (``action``,
    ``carry_new``) of that episode; ``carry_ref``: the reference
    controller's next carry from the same inputs, or None. ``ocp`` is the
    frozen OCP of the configuration, unbatched; ``env_cfg`` the frozen
    env configuration.

    - ``plan_gap``: the served action and the next carry against the plan
      the program adopted (its ``z_prev``), as ``campc.campc_action``
      derives them: the action is the plan's first control (or, where the
      program reports its solve rejected, the brake), the next step's
      anchors are the plan's first stage, the door-yield counters are the
      reference's update, and the carry's flags follow its decision. A
      flag or counter that differs counts as infinite.
    - ``cost``: the cost of the program's adopted plan, of the
      reference's and of the reference's start guess, and whether each
      side accepted its solve (``ok``), where ``carry_ref`` is given."""
    C, SD = R.C, R.SD
    cfg = ocp.cfg
    state, carry = inp["state"], inp["carry"]
    view, mid, lw0, intent = SD.mpc_inputs(ocp, state, inp["forecasts"],
                                           inp["log_w"])
    params, (stall, latch), _ = C.step_problem(ocp, view, carry, env_cfg,
                                               mid, lw0, intent)
    new = inp["carry_new"]
    flags_ok = (bool(new.has_prev) and
                int(new.door_stall) == int(stall) and
                bool(new.door_latch) == bool(latch) and
                int(new.num_prev_used) == (0 if bool(new.prev_ok) else
                                           int(carry.num_prev_used) + 1))
    z = new.z_prev
    u_rob, u_hums, _, _ = ocp.unpack(z)
    Xr, Xh = ocp.rollout(params, u_rob, u_hums)
    pose = C._rob_pose(ocp, Xr[1])
    anchor = max(float((new.pred_rob[:2] - pose[:2]).abs().max()),
                 float(_angle(new.pred_rob[2] - pose[2]).abs()),
                 float((new.pred_hums - Xh[1][:, :2]).abs().max()))
    action = inp["action"]
    plan_a = torch.stack([u_rob[0, 0], u_rob[0, 1] * cfg.dt])
    gap = float((action - plan_a).abs().max())
    if not bool(new.prev_ok):
        if cfg.evasive_brake:
            b = C._evasive_brake_action(ocp, params)
        else:
            v = torch.clamp(ocp.rob_v_prev(params.x0_rob) +
                            cfg.max_l_dcc * cfg.dt, min=0.0)
            b = torch.stack([v, torch.zeros_like(v)])
        brake = torch.stack([b[0], b[1] * cfg.dt])
        gap = min(gap, float((action - brake).abs().max()))
    plan_gap = max(gap, anchor) if flags_ok else math.inf
    if not math.isfinite(float(action.abs().max())):
        plan_gap = math.inf
    out = {"plan_gap": plan_gap, "ok_p": bool(new.prev_ok),
           "J_p": float(ocp.cost(z, params))}
    if carry_ref is not None:
        guess = C._select_guess(ocp, carry, params)
        out.update(ok_r=bool(carry_ref.prev_ok),
                   J_r=float(ocp.cost(carry_ref.z_prev, params)),
                   J_g=float(ocp.cost(guess, params)))
        for side, zz in (("p", z), ("r", carry_ref.z_prev), ("g", guess)):
            c_e, c_i = ocp.residuals(zz, params)
            out[f"E_{side}"] = float(c_e.abs().max()) if c_e.numel() else 0.0
            out[f"I_{side}"] = (float(torch.clamp(c_i.max(), min=0.0))
                                if c_i.numel() else 0.0)
    return out


def log_controller(log, readings):
    """One line of each episode's controller readings that the reference
    solved, and the worst plan gap."""
    log(f"controller: worst plan gap "
        f"{max((r['plan_gap'] for r in readings), default=0.0):.3e} over "
        f"{len(readings)} episode-steps")
    for r in readings:
        if "J_r" in r:
            log("controller solved: " + " ".join(
                f"{k} {v!r}" for k, v in r.items()))


def cost_gap(readings) -> float:
    """The worst episode's cost of the program's adopted plan above the
    reference's, over the larger of the reference's cost and 1."""
    worst = 0.0
    for r in readings:
        if "J_r" not in r:
            continue
        if not math.isfinite(r["J_p"]):
            return math.inf
        worst = max(worst, (r["J_p"] - r["J_r"]) / max(abs(r["J_r"]), 1.0))
    return worst


def stall_gap(readings) -> float:
    """The worst episode, among those whose solve the program accepted, of
    how far the reference's solve moved the cost from the start guess over
    how far the program's did: about 1 where both solved, however
    differently rounding led them, and ~1e5 or more where the program
    served its start guess as a solution. The program's move is floored at
    1e-6 of the guess's cost, the rounding of the guess itself."""
    worst = 0.0
    for r in readings:
        if "J_r" not in r or not r["ok_p"]:
            continue
        floor = 1e-6 * max(abs(r["J_g"]), 1.0)
        moved = abs(r["J_g"] - r["J_p"])
        if not math.isfinite(moved):
            return math.inf
        worst = max(worst, abs(r["J_g"] - r["J_r"]) / max(moved, floor))
    return worst

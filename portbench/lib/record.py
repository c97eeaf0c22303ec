"""Taps on the program's calls: what the timed path itself produced,
kept by reference (no copy, no sync) for the comparison after the
window, and the faults that the harness's own tests plant under it."""

from __future__ import annotations

import dataclasses

import torch

from portbench.lib.spans import wrap


class ForecastTap:
    """Keeps the last call of ``diffusion.kde.most_likely_samples``: the
    samples the forecaster ranked and its ranking (top k, log-weights)."""

    def __init__(self, ns):
        self.last = None
        self.restore = wrap(ns.kde, "most_likely_samples", self._wrapper)

    def _wrapper(self, fn):
        def inner(samples, *args, **kwargs):
            top, lw = fn(samples, *args, **kwargs)
            self.last = (samples, top, lw)
            return top, lw
        return inner


class KDEShapeTap:
    """Counts the KDE kernel's launches of a traced window by shape
    (G, S, D): every launch on the cells' paths comes from
    ``diffusion.kde.most_likely_samples`` through ``kde_loglik_fused``."""

    def __init__(self, ns, enabled: bool):
        self.shapes = []
        self.active = False
        self.restore = (wrap(ns.kde, "kde_loglik_fused", self._wrapper)
                        if enabled else (lambda: None))

    def _wrapper(self, fn):
        def inner(preds, bandwidth):
            if self.active:
                self.shapes.append(tuple(preds.shape))
            return fn(preds, bandwidth)
        return inner


class ControllerTap:
    """Keeps every call of the controller half of a control step,
    ``mpc/sicnav_diffusion.act_on_forecasts_batch`` (``batch``) or
    ``act_on_forecasts``: its inputs (the state, the MPC carry, the served
    forecasts and log-weights) and what it returned (the action and the
    next MPC carry), by reference."""

    def __init__(self, ns, batch: bool):
        self.calls = []
        name = "act_on_forecasts_batch" if batch else "act_on_forecasts"
        self.restore = wrap(ns.SD, name, self._wrapper)

    def _wrapper(self, fn):
        def inner(ocp, state, carry, forecasts, log_w, *args, **kwargs):
            out = fn(ocp, state, carry, forecasts, log_w, *args, **kwargs)
            self.calls.append({"state": state, "carry": carry,
                               "forecasts": forecasts, "log_w": log_w,
                               "action": out[0], "carry_new": out[1]})
            return out
        return inner


ALTER = 0.05    # what a planted fault adds to an answer


def _half_mean(tree, h):
    """Episodes h: of a batched tree replaced by the mean of episodes :h
    (a float leaf), or by episode 0 (an integer or boolean leaf)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_half_mean(x, h) for x in tree])
    x = tree.clone()
    x[h:] = x[:h].mean(dim=0) if x.is_floating_point() else x[0]
    return x


def _splice(a, b, h):
    """Episodes :h of tree ``a`` and h: of tree ``b``."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*[_splice(x, y, h) for x, y in zip(a, b)])
    return torch.cat([a[:h], b[h:]], dim=0)


def _controller_fault(fault):
    """A wrapper of the controller half that plants ``fault``:
    ``mpc_carry_unchanged`` hands back the MPC carry it was given;
    ``mpc_action_zero`` serves a zero action; ``mpc_action_altered`` adds
    ``ALTER`` to the action it serves; ``mpc_fewer_iterations``
    solves with half the configured IPM iterations; ``mpc_unsolved``
    serves every episode its start guess (a solve of no iteration), and
    ``mpc_half_unsolved`` the second half of the episodes;
    ``mpc_half_batch`` serves the second half of the episodes the mean of
    the first half's actions and carries."""
    def w(fn):
        def inner(ocp, state, carry, fc, lw, env_cfg, settings, *a, **k):
            if fault == "mpc_fewer_iterations":
                settings = dataclasses.replace(
                    settings, n_iter=settings.n_iter // 2)
            elif fault == "mpc_unsolved":
                settings = dataclasses.replace(settings, n_iter=0)
            out = fn(ocp, state, carry, fc, lw, env_cfg, settings, *a, **k)
            action, carry_new = out[0], out[1]
            if fault == "mpc_carry_unchanged":
                carry_new = carry
            elif fault == "mpc_action_zero":
                action = torch.zeros_like(action)
            elif fault == "mpc_action_altered":
                action = action + ALTER
            elif fault == "mpc_half_unsolved":
                h = action.shape[0] // 2
                idle = fn(ocp, state, carry, fc, lw, env_cfg,
                          dataclasses.replace(settings, n_iter=0), *a, **k)
                action = _splice(action, idle[0], h)
                carry_new = _splice(carry_new, idle[1], h)
            elif fault == "mpc_half_batch":
                h = action.shape[0] // 2
                action = _half_mean(action, h)
                carry_new = _half_mean(carry_new, h)
            return (action, carry_new) + tuple(out[2:])
        return inner
    return w


CONTROLLER_FAULTS = {
    "eval": ("mpc_carry_unchanged", "mpc_action_zero", "mpc_action_altered",
             "mpc_fewer_iterations", "mpc_half_unsolved", "mpc_half_batch"),
    "robot": ("mpc_carry_unchanged", "mpc_action_zero", "mpc_action_altered",
              "mpc_fewer_iterations", "mpc_unsolved"),
}


def plant(fault, ns, kind: str):
    """Plant ``fault`` under the timed path of a cell of ``kind`` (eval,
    robot); returns the restorer. Only the harness's tests and the
    calibration call this, to see ``correct`` come out false. A fault on
    the forecaster's samples wraps the ``ForecastTap``, so the tap keeps
    what the faulty program ranked; a fault of the controller is planted
    under the ``ControllerTap``, so the tap keeps what it served."""
    if fault is None:
        return lambda: None
    undo = []
    if fault in CONTROLLER_FAULTS.get(kind, ()):
        name = "act_on_forecasts_batch" if kind == "eval" \
            else "act_on_forecasts"
        undo.append(wrap(ns.SD, name, _controller_fault(fault)))
    elif kind == "eval" and fault == "state_unchanged":
        def w(fn):
            def inner(state, action, cfg):
                _, reward, info = fn(state, action, cfg)
                return state, reward, info
            return inner
        undo.append(wrap(ns.crowd_sim, "step_masked", w))
    elif kind == "eval" and fault == "half_batch":
        # the forecaster serves half of the episodes; the rest get the
        # mean of their samples
        def w(fn):
            def inner(samples, *args, **kwargs):
                h = samples.shape[0] // 2
                samples = samples.clone()
                samples[h:] = samples[:h].mean(dim=0)
                return fn(samples, *args, **kwargs)
            return inner
        undo.append(wrap(ns.kde, "most_likely_samples", w))
    elif kind in ("eval", "robot") and fault == "kde_altered":
        # the KDE kernel's best score of each group altered where the
        # kernel produces it: the best sample is always served
        def w(fn):
            def inner(preds, bandwidth):
                ll = fn(preds, bandwidth).clone()
                best = ll.argmax(dim=-1, keepdim=True)
                ll.scatter_add_(-1, best, torch.full_like(best, ALTER,
                                                          dtype=ll.dtype))
                return ll
            return inner
        undo.append(wrap(ns.kde, "kde_loglik_fused", w))
    elif kind in ("eval", "robot") and fault == "answer_altered":
        # one forecast sample altered where the forecaster produces it
        def w(fn):
            def inner(samples, *args, **kwargs):
                samples = samples.clone()
                samples[..., 0, 0, 0, :] += ALTER
                return fn(samples, *args, **kwargs)
            return inner
        undo.append(wrap(ns.kde, "most_likely_samples", w))
    elif kind == "robot" and fault == "state_unchanged":
        def w(fn):
            held = []

            def inner(*args, **kwargs):
                out = fn(*args, **kwargs)
                if not held:
                    held.append(out)
                return held[0]
            return inner
        undo.append(wrap(ns.realtime.StreamingController, "_build_state", w))
    else:
        raise ValueError(f"no fault {fault!r} for a {kind} cell")

    def restore():
        for u in reversed(undo):
            u()
    return restore


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

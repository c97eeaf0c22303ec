"""Closed-loop evaluation: batches of protocol cases stepped as
``harness.evaluate_policy`` steps them.

The window drives the batched control step of
``mpc/sicnav_diffusion.make_policy(batch=True)`` and then
``env/crowd_sim.step_masked``, the loop body of
``env/rollout.rollout_episode_stateful``; after ``steps_per_batch`` steps
the next cases are reset (``crowd_sim.reset_batch`` and the policy's
``init_carry_fn``). Set-up runs the first control step of the first batch.

``correct``: after the window, each step of the window is followed by the
reference from the program's own state before it (the forecaster's
history and noise generators, the controller's carry, which only the
program's run makes): the forecaster in float64 from the same noise, its
ranking by the reference's scores, the served action and next carry
against the plan the program adopted, and the env step on the program's
action. On ``ref_steps`` steps drawn from the seed the reference's
controller solves the same problems in float64, and the program's move
from each start guess is held to the reference's. The reset of the first
batch is checked whole.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.lib import flops, port, record, trace
from portbench.lib.spans import Spans, spanned, wrap
from portbench.lib.window import Window
from portbench.reference import compare


def _cases(rng, wl, n):
    lo, hi = wl["cases"]
    return [int(c) for c in rng.choice(np.arange(lo, hi), size=n,
                                       replace=False)]


def run(ctx):
    dev = ctx.device
    wl, cfg = ctx.workload, ctx.config
    ns = port.namespace(ctx.program)
    port.set_tf32(ctx.program == "frozen")
    B = int(ctx.size("batch", wl["batch"]))
    env_kw = dict(cfg["env"], time_limit=ctx.size("time_limit",
                                                  cfg["env"]["time_limit"]))
    env_cfg = ns.env_types.EnvConfig(**env_kw)
    wl = dict(wl, ipm=ctx.size("ipm", wl["ipm"]))
    state_dict = port.load_weights(cfg["model"]["weights"])
    model = port.jmid_model(ns, cfg, state_dict, dev)
    fcfg = port.forecaster_config(ns, cfg, env_cfg)
    settings = port.ipm_settings(ns, wl, env_cfg.max_humans)
    ocp, init_carry_fn, step_fn = ns.SD.make_policy(
        env_cfg, model, fcfg=fcfg, settings=settings, device=dev, batch=True,
        **port.policy_kwargs(cfg))
    port.check_ocp(cfg, ocp)
    steps_per_batch = int(env_cfg.time_limit / env_cfg.dt) + 2

    spans = Spans(ctx.trace, dev)
    tap = record.ForecastTap(ns)
    undo = [tap.restore, record.plant(ctx.fault, ns, "eval")]
    kde_tap = record.KDEShapeTap(ns, ctx.trace)
    ctl_tap = record.ControllerTap(ns, batch=True)
    undo += [kde_tap.restore, ctl_tap.restore]
    if ctx.trace:
        undo.append(wrap(ns.FC, "predict_ret_best",
                         spanned(spans, "forecast")))
        undo.append(wrap(ns.SD, "act_on_forecasts_batch",
                         spanned(spans, "mpc")))

    rng = np.random.default_rng(ctx.seed)
    cases = _cases(rng, wl, B)
    first_cases = list(cases)
    states = ns.crowd_sim.reset_batch(env_cfg, cases, device=dev)
    first_reset = states
    carries = init_carry_fn(cases)

    def control_step(states, carries):
        rec = {"states": states, "carries": carries,
               "gens": [g.get_state() for g in carries.generator]}
        actions, carries = step_fn(states, carries)
        with spans.span("env_step"):
            new_states, _, _ = ns.crowd_sim.step_masked(states, actions,
                                                        env_cfg)
        rec.update(actions=actions, new_states=new_states, fc=tap.last,
                   mpc=ctl_tap.calls.pop())
        return new_states, carries, rec

    # set-up: the first control step of the first batch
    states, carries, _ = control_step(states, carries)
    record.sync(dev)
    step_in_batch = 1
    ctx.log(f"eval: cases {cases}, B = {B}, "
            f"{settings.n_iter} IPM iterations, {steps_per_batch} steps "
            "a batch")

    win = Window(ctx.seconds)
    t_window = win.start()
    spans.times.clear()
    recs, failed = [], 0
    while win.open:
        if step_in_batch == steps_per_batch:
            cases = _cases(rng, wl, B)
            states = ns.crowd_sim.reset_batch(env_cfg, cases, device=dev)
            carries = init_carry_fn(cases)
            step_in_batch = 0
        with spans.span("step"):
            states, carries, rec = control_step(states, carries)
        step_in_batch += 1
        record.sync(dev)
        failed += int((~torch.isfinite(rec["actions"]).all(dim=-1)).sum())
        recs.append(rec)
        win.done(B)
    ctx.log(f"eval: window {win.elapsed:.3f} s, {win.units} batched steps, "
            f"{win.work:.0f} episode-steps")

    out = {"t_window_start": t_window, "attempted": int(win.work),
           "failed": failed,
           "e2e": {"episode_steps_per_s": win.rate()}}
    if ctx.trace:
        kde_tap.active = True
        spans.keep_times = False
        summary = trace.profile(
            lambda: control_step(states, carries), 1,
            lambda: record.sync(dev))
        kde_tap.active = False
        step_ms = spans.per_unit_ms("step", "step")
        counts = flops.control_step(
            B, env_cfg.max_humans, fcfg.past_frames, fcfg.horizon,
            fcfg.num_samples, 100 // fcfg.ddim_stride,
            cfg["model"]["widths"]["context_dim"], 128,
            cfg["model"]["widths"]["tf_layer"], cfg["mpc"]["kkt_dim"],
            settings.n_iter)
        out["layer"] = {"spans": spans, "trace": summary, "step_ms": step_ms,
                        "step_flops": counts, "kde_shapes": kde_tap.shapes}
        out["trace"] = summary
    out["memory_peak_bytes"] = ctx.memory_peak()
    for u in reversed(undo):
        u()

    # the reference, after the window, with the program's state freed
    del model, step_fn, init_carry_fn, states, carries, ocp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(ctx, env_kw, state_dict, first_cases, first_reset,
                          recs)
    return out


def check(ctx, env_kw, state_dict, cases, prog_reset, recs):
    """The reference's numbers for every recorded step of the window: the
    worst gap of the reset, the env step and the forecast samples
    (``outputs_gap``); the ranking's regret and log-weight gap, judged by
    the reference's scores of the samples the program ranked; the
    served actions and carries against the adopted plans (``plan_gap``);
    and on ``ref_steps`` steps drawn from the seed, the reference
    controller's solve of the same problems against the program's: the
    adopted plans' cost above the reference's (``cost_gap``) and the
    reference's move from the start guess over the program's
    (``stall_gap``). The workload's
    ``limits`` name the numbers compared; the others are logged."""
    dev, cfg, wl = ctx.device, ctx.config, ctx.workload
    R = port.namespace("frozen")
    port.set_tf32(False)
    ref_cfg = R.env_types.EnvConfig(**env_kw)
    model = port.jmid_model(R, cfg, state_dict, dev, torch.float64)
    fcfg = port.forecaster_config(R, cfg, ref_cfg)
    settings = port.ipm_settings(R, dict(wl, ipm=ctx.size("ipm", wl["ipm"])),
                                 ref_cfg.max_humans)
    ocp_b, _, _ = R.SD.make_policy(ref_cfg, None, fcfg=fcfg,
                                   settings=settings, device=dev, batch=True,
                                   **port.policy_kwargs(cfg))
    ocp = R.SD.OCP(ocp_b.cfg, device=dev, vmapped=False)
    ref_reset = R.crowd_sim.reset_batch(ref_cfg, cases, device=dev)
    outputs = [compare.tree_gap(prog_reset, ref_reset)]
    regrets, lw_gaps, ctl = [], [], []
    rng = np.random.default_rng([ctx.seed, 1])
    solved = set(rng.choice(len(recs), size=min(wl["ref_steps"], len(recs)),
                            replace=False).tolist()) if recs else set()
    for i, rec in enumerate(recs):
        states, carries = rec["states"], rec["carries"]
        tap = record.ForecastTap(R)
        try:
            fstate = R.FC.update_state_hists(carries.forecaster, states,
                                             fcfg)
            gens = port.generators_like(rec["gens"], dev)
            R.FC.predict_ret_best(model, port.to_double(fstate),
                                  port.to_double(states), fcfg,
                                  generator=gens)
        finally:
            tap.restore()
        ref_samples = tap.last[0]
        # the ranking is judged on the samples it ranked
        ref_lik = compare.joint_likelihood(R.kde_ops, R.geometry,
                                           rec["fc"][0].double())
        sample_gap, regret, lw_gap = compare.forecast_numbers(
            rec["fc"], ref_samples, ref_lik)
        new_states, _, _ = R.crowd_sim.step_masked(states, rec["actions"],
                                                   ref_cfg)
        env_gap = compare.tree_gap(rec["new_states"], new_states)
        outputs.append(max(env_gap, sample_gap))
        regrets.append(regret)
        lw_gaps.append(lw_gap)

        inp = port.to_double(rec["mpc"])
        carry_ref = None
        if i in solved:
            _, carry_ref = R.SD.act_on_forecasts_batch(
                ocp_b, inp["state"], inp["carry"], inp["forecasts"],
                inp["log_w"], ref_cfg, settings)
        for b in range(inp["action"].shape[0]):
            ctl.append(compare.controller_numbers(
                R, ocp, ref_cfg, {k: port.index(v, b) for k, v in inp.items()},
                None if carry_ref is None else port.index(carry_ref, b)))
    numbers = {"outputs_gap": max(outputs), "regret_gap": max(regrets),
               "logw_gap": max(lw_gaps),
               "plan_gap": max(r["plan_gap"] for r in ctl),
               "cost_gap": compare.cost_gap(ctl),
               "stall_gap": compare.stall_gap(ctl)}
    ctx.log(f"eval check of the reset and {len(recs)} steps: env and "
            f"samples {np.array2string(np.asarray(outputs), precision=3)}; "
            f"regret {np.array2string(np.asarray(regrets), precision=3)}; "
            f"log-weights {np.array2string(np.asarray(lw_gaps), precision=3)}")
    compare.log_controller(ctx.log, ctl)
    limits = wl["limits"]
    return [(n, v, limits.get(n)) for n, v in numbers.items()]

"""One robot: the streaming controller at 10 Hz on a recorded sensor
stream, as ``scripts/real_robot_loop_torch.py`` runs it.

The stream is the benchmark's own copy of that script's
``record_stream``: a DWA episode of protocol case ``seed mod 500`` (and of
the cases after it, appended, so that the stream outlasts the window at
any tick rate), sampled at ``sensor_hz`` with Gaussian jitter. Ticks are
due every 1 / control_hz of stream time; tick k takes every sample up to
its due time, and a late tick starts as soon as the one before it ends.
The window drives ``realtime.StreamingController.observe`` and
``select_action`` (B = 1, the unbatched OCP at ``ipm.realtime_settings``);
a tick's latency is the host clock around ``select_action``, which ends
in a device sync and a copy to the host. Set-up runs the first tick.

``correct``: after the window, each tick of the window is followed by the
reference from the program's own state before it (the stream buffer, the
noise generator, the controller's carry): the resample and the state it
builds, the forecaster in float64 from the same noise and its ranking by
the reference's scores, and the served action and next carry against the
plan the program adopted. On ``ref_ticks`` ticks drawn from the seed
among those whose solve the program accepted, the reference's controller
solves the same problem in float64, and the program's move from its start
guess is held to the reference's.

The streaming controller takes one of the configuration's controller
options, ``ral``; a configuration whose other options build another
controller than the streaming one is refused.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.lib import flops, port, record, trace
from portbench.lib.spans import Spans, spanned, wrap
from portbench.lib.window import Window, percentile
from portbench.reference import compare


def record_stream(R, env_cfg, cases, sensor_hz, jitter_s, rng, device):
    """DWA episodes of ``cases`` on the reference's simulator, one after
    the other, upsampled to a sensor feed: a list of (t, (x, y, th),
    (H, 2), case index) and each case's (goal, active walls). Copied from
    ``scripts/real_robot_loop_torch.py``'s ``record_stream`` (one batch of
    episodes in place of one, times shifted to follow each other)."""
    state = R.crowd_sim.reset_batch(env_cfg, cases, device=device)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    traj = []
    for _ in range(max_steps):
        action = R.dwa.dwa_policy_batch(state, env_cfg)
        state, _, _ = R.crowd_sim.step_masked(state, action, env_cfg)
        traj.append((state.r_pos, state.r_theta, state.h_pos))
    r_pos = torch.stack([t[0] for t in traj], 1).cpu().numpy()   # (C, T, 2)
    r_th = torch.stack([t[1] for t in traj], 1).cpu().numpy()
    h_pos = torch.stack([t[2] for t in traj], 1).cpu().numpy()   # (C, T, H, 2)
    goals = state.r_goal.cpu().numpy()
    walls = state.walls.cpu().numpy()
    wmask = state.wall_mask.cpu().numpy()
    T = r_pos.shape[1]
    t_sim = np.arange(T) * env_cfg.dt
    span = t_sim[-1] + env_cfg.dt
    stream, meta = [], []
    for c in range(len(cases)):
        t_feed = np.arange(0.0, t_sim[-1], 1.0 / sensor_hz)
        t_feed = np.clip(t_feed + rng.normal(0, jitter_s, t_feed.shape),
                         0.0, t_sim[-1])
        t_feed.sort()
        th = np.unwrap(r_th[c])
        H = h_pos.shape[2]
        for t in t_feed:
            rx = np.interp(t, t_sim, r_pos[c, :, 0])
            ry = np.interp(t, t_sim, r_pos[c, :, 1])
            rt = np.interp(t, t_sim, th)
            hp = np.stack([[np.interp(t, t_sim, h_pos[c, :, h, d])
                            for d in range(2)] for h in range(H)])
            stream.append((float(t + c * span), (rx, ry, rt), hp, c))
        meta.append((goals[c], walls[c][wmask[c]]))
    return stream, meta


class _Tick:
    """What one tick's timed path produced, and the state it started from."""

    def __init__(self, ctl):
        b = ctl.buffer
        with b.lock:
            self.buffer = (list(b.t), list(b.robot), list(b.humans))
        self.gen = ctl.carry.generator.get_state()
        self.ctl_fields = {k: getattr(ctl, k) for k in (
            "goal", "walls", "wall_mask", "_prev_cmd", "_have_prev",
            "_step_idx")}
        self.built = None
        self.fc = None
        self.action = None
        self.mpc = None


def run(ctx):
    dev = ctx.device
    wl, cfg = ctx.workload, ctx.config
    ns = port.namespace(ctx.program)
    R = port.namespace("frozen")
    port.set_tf32(ctx.program == "frozen")
    env_kw = dict(cfg["env"])
    env_cfg = ns.env_types.EnvConfig(**env_kw)
    ref_cfg = R.env_types.EnvConfig(**env_kw)
    wl = dict(wl, ipm=ctx.size("ipm", wl["ipm"]))
    state_dict = port.load_weights(cfg["model"]["weights"])
    model = port.jmid_model(ns, cfg, state_dict, dev)
    fcfg = port.forecaster_config(ns, cfg, env_cfg)
    settings = port.ipm_settings(ns, wl, env_cfg.max_humans)

    rng = np.random.default_rng(ctx.seed)
    lo, hi = wl["cases"]
    cases = [lo + (ctx.seed + i) % (hi - lo)
             for i in range(wl["stream_cases"])]
    stream, meta = record_stream(R, ref_cfg, cases, wl["sensor_hz"],
                                 wl["jitter_ms"] / 1000.0, rng, dev)

    spans = Spans(ctx.trace, dev)
    tap = record.ForecastTap(ns)
    undo = [tap.restore, record.plant(ctx.fault, ns, "robot")]
    kde_tap = record.KDEShapeTap(ns, ctx.trace)
    ctl_tap = record.ControllerTap(ns, batch=False)
    undo += [kde_tap.restore, ctl_tap.restore]
    built = {}

    def build_tap(fn):
        def inner(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            built["last"] = out
            return out
        return inner

    observe = spanned(spans, "observe")
    undo.append(wrap(ns.realtime.StreamingController, "_build_state",
                     lambda fn: observe(build_tap(fn))))
    if ctx.trace:
        undo.append(wrap(ns.realtime.StreamingController, "_to_device",
                         lambda fn: spanned(spans, "observe")(fn)))
        undo.append(wrap(ns.FC, "predict_ret_best",
                         spanned(spans, "forecast")))
        undo.append(wrap(ns.SD, "act_on_forecasts", spanned(spans, "mpc")))

    ctl = ns.realtime.StreamingController(env_cfg, model, fcfg=fcfg,
                                          settings=settings,
                                          ral=cfg["mpc"]["ral"], device=dev)
    stated, _ = ns.SD.make_policy(env_cfg, model, fcfg=fcfg,
                                  settings=settings, device=dev,
                                  **port.policy_kwargs(cfg))
    if stated.cfg != ctl.ocp.cfg:
        raise ValueError("the streaming controller takes only the option "
                         "ral; the configuration's other controller options "
                         "build another MPC")
    port.check_ocp(cfg, ctl.ocp)
    del stated
    feed = {"i": 0, "case": -1}

    def push_until(t_due):
        while feed["i"] < len(stream) and stream[feed["i"]][0] <= t_due:
            t, pose, hums, c = stream[feed["i"]]
            if c != feed["case"]:
                # the next recorded episode: a fresh intake, its goal and
                # its walls
                feed["case"] = c
                ctl.buffer = ns.realtime.ObservationBuffer(
                    env_cfg.max_humans)
                ctl.set_goal(meta[c][0])
                ctl.set_static_obstacles(meta[c][1])
            ctl.observe(t, pose, hums)
            feed["i"] += 1

    def tick():
        rec = _Tick(ctl)
        t0 = time.perf_counter()
        ctl.select_action()
        lat = time.perf_counter() - t0
        rec.built, rec.fc = built["last"], tap.last
        rec.action = np.asarray(ctl._prev_cmd)
        rec.mpc = ctl_tap.calls.pop()
        return rec, lat

    # set-up: the first second of the stream and the first tick
    period = 1.0 / wl["control_hz"]
    t_due = float(wl["warmup_stream_s"])
    push_until(t_due)
    tick()
    ctx.log(f"robot: cases {cases}, {len(stream)} sensor samples, "
            f"{settings.n_iter} IPM iterations")

    win = Window(ctx.seconds)
    t_window = win.start()
    spans.times.clear()
    recs, failed = [], 0
    while win.open:
        t_due += period
        push_until(t_due)
        with spans.span("tick"):
            rec, lat = tick()
        failed += int(not np.isfinite(rec.action).all())
        recs.append(rec)
        win.done(1, sample=lat)
        # on time: wait for the next tick's due time on the wall clock
        ahead = t_window + win.units * period - time.perf_counter()
        if win.open and ahead > 0:
            time.sleep(ahead)
    lat_ms = 1e3 * np.asarray(win.samples)
    ctx.log(f"robot: window {win.elapsed:.3f} s, {win.units} ticks, "
            f"latency ms min {lat_ms.min():.2f} p50 "
            f"{percentile(lat_ms, 50):.2f} max {lat_ms.max():.2f}")

    out = {"t_window_start": t_window, "attempted": win.units,
           "failed": failed,
           "e2e": {"tick_p95_ms": percentile(lat_ms, 95)}}
    if ctx.trace:
        kde_tap.active = True
        spans.keep_times = False
        t_due += period
        push_until(t_due)
        summary = trace.profile(tick, 1, lambda: record.sync(dev))
        kde_tap.active = False
        counts = flops.control_step(
            1, env_cfg.max_humans, fcfg.past_frames, fcfg.horizon,
            fcfg.num_samples, 100 // fcfg.ddim_stride,
            cfg["model"]["widths"]["context_dim"], 128,
            cfg["model"]["widths"]["tf_layer"], cfg["mpc"]["kkt_dim"],
            settings.n_iter)
        out["layer"] = {"spans": spans, "trace": summary,
                        "step_ms": spans.per_unit_ms("tick", "tick"),
                        "step_flops": counts, "kde_shapes": kde_tap.shapes}
        out["trace"] = summary
    out["memory_peak_bytes"] = ctx.memory_peak()
    for u in reversed(undo):
        u()

    del model, ctl
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(ctx, R, ref_cfg, state_dict, recs)
    return out


def check(ctx, R, ref_cfg, state_dict, recs):
    """The reference's numbers for every recorded tick of the window: the
    worst tick's built state and samples (``outputs_gap``), the worst
    ranking's regret and log-weight gap, judged by the reference's scores
    of the samples the program ranked, the served actions and carries
    against the adopted plans (``plan_gap``), and on ``ref_ticks``
    accepted ticks drawn from the seed the reference controller's solve of
    the same problem against the program's (``cost_gap``, ``stall_gap``:
    see ``eval_loop.check``). The workload's ``limits`` name the numbers
    compared; the others are logged."""
    dev, cfg, wl = ctx.device, ctx.config, ctx.workload
    port.set_tf32(False)
    model = port.jmid_model(R, cfg, state_dict, dev, torch.float64)
    fcfg = port.forecaster_config(R, cfg, ref_cfg)
    settings = port.ipm_settings(R, dict(wl, ipm=ctx.size("ipm", wl["ipm"])),
                                 ref_cfg.max_humans)
    ctl = R.realtime.StreamingController(ref_cfg, model, fcfg=fcfg,
                                         device=dev)
    ocp, _ = R.SD.make_policy(ref_cfg, None, fcfg=fcfg, settings=settings,
                              device=dev, **port.policy_kwargs(cfg))
    # the reference solves ticks whose solve the program accepted, drawn
    # from the seed: a rejected solve serves the start guess by design
    accepted = [i for i, rec in enumerate(recs)
                if bool(rec.mpc["carry_new"].prev_ok)]
    rng = np.random.default_rng([ctx.seed, 1])
    solved = set(rng.choice(accepted, size=min(wl["ref_ticks"],
                                               len(accepted)),
                            replace=False).tolist()) if accepted else set()
    outputs, regrets, lw_gaps, readings = [], [], [], []
    for i, rec in enumerate(recs):
        for k, v in rec.ctl_fields.items():
            setattr(ctl, k, v)
        ctl.buffer.t, ctl.buffer.robot, ctl.buffer.humans = rec.buffer
        state_np, fstate_np = ctl._build_state()
        state_gap = compare.tree_gap(rec.built, (state_np, fstate_np))
        state, fstate = (port.to_double(t) for t in
                         ctl._to_device(state_np, fstate_np))
        gen = port.generators_like([rec.gen], dev)[0]
        tap = record.ForecastTap(R)
        try:
            fstate = R.FC.update_state_hists(fstate, state, fcfg)
            R.FC.predict_ret_best(model, fstate, state, fcfg, generator=gen)
        finally:
            tap.restore()
        ref_samples = tap.last[0][None]
        samples, top, lw = rec.fc
        # the ranking is judged on the samples it ranked
        ref_lik = compare.joint_likelihood(R.kde_ops, R.geometry,
                                           samples[None].double())
        sample_gap, regret, lw_gap = compare.forecast_numbers(
            (samples[None], top[None], lw[None]), ref_samples, ref_lik)
        outputs.append(max(state_gap, sample_gap))
        regrets.append(regret)
        lw_gaps.append(lw_gap)

        inp = port.to_double(rec.mpc)
        carry_ref = None
        if i in solved:
            _, carry_ref = R.SD.act_on_forecasts(
                ocp, inp["state"], inp["carry"], inp["forecasts"],
                inp["log_w"], ref_cfg, settings)
        readings.append(compare.controller_numbers(R, ocp, ref_cfg, inp,
                                                   carry_ref))
    numbers = {"outputs_gap": max(outputs), "regret_gap": max(regrets),
               "logw_gap": max(lw_gaps),
               "plan_gap": max(r["plan_gap"] for r in readings),
               "cost_gap": compare.cost_gap(readings),
               "stall_gap": compare.stall_gap(readings)}
    ctx.log(f"robot check of {len(recs)} ticks: state and samples "
            f"{np.array2string(np.asarray(outputs), precision=3)}; regret "
            f"{np.array2string(np.asarray(regrets), precision=3)}; "
            f"log-weights {np.array2string(np.asarray(lw_gaps), precision=3)}")
    compare.log_controller(ctx.log, readings)
    limits = wl["limits"]
    return [(n, v, limits.get(n)) for n, v in numbers.items()]

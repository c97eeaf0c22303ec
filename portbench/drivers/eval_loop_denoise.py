"""Closed-loop evaluation as ``eval_loop`` runs it, with the DDIM loop
timed on its own in a traced run.

``eval_loop.run`` runs unchanged but for the draw of the cases: the
workload's ``stalled_resets`` are left out of the pool. For those the
scenario's rejection sampling of the humans' start positions
(``env/scenarios.generate_host``, the reference's loop, which the JAX
package and the frozen reference share) finds a free place for the last
humans after minutes or never, so a reset of them would outlast the run.

With ``--trace 1`` the program's ``JMIDModel.sample`` (the encoder, the
DDIM passes and the integration of the velocities) runs inside a span
that ends in a device sync, and the window's steps give ``denoise_ms``:
milliseconds in ``sample`` a batched step. ``denoise_flops`` is the
denoiser's counted work a step, from the configuration's shapes:
``flops.concat_linear_denoiser`` for one episode's samples, times the
DDIM passes and the batch.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.lib import flops, port, registry
from portbench.lib.spans import Spans, spanned, wrap


def denoise_flops(ns, cfg, batch):
    """The joint denoiser's operations in one control step of ``batch``
    episodes."""
    env_cfg = ns.env_types.EnvConfig(**cfg["env"])
    fcfg = port.forecaster_config(ns, cfg, env_cfg)
    mcfg = port.model_config(ns, cfg)
    A = env_cfg.max_humans
    one = flops.concat_linear_denoiser(
        fcfg.num_samples, A * fcfg.horizon, A, mcfg.context_dim,
        mcfg.enc_rnn_dim, mcfg.tf_layer)
    return batch * (100 // fcfg.ddim_stride) * one


def run(ctx):
    inner = registry.driver("eval_loop")
    skip = ctx.workload.get("stalled_resets", [])

    def cases(rng, wl, n):
        lo, hi = wl["cases"]
        pool = np.setdiff1d(np.arange(lo, hi), skip)
        return [int(c) for c in rng.choice(pool, size=n, replace=False)]

    restore_cases = wrap(inner, "_cases", lambda _: cases)
    if not ctx.trace:
        try:
            return inner.run(ctx)
        finally:
            restore_cases()
    ns = port.namespace(ctx.program)
    spans = Spans(True, ctx.device)
    starts = []

    def timed(fn):
        fn = spanned(spans, "denoise")(fn)

        def sample(*args, **kwargs):
            starts.append(time.perf_counter())
            return fn(*args, **kwargs)
        return sample

    restore = wrap(ns.mid.JMIDModel, "sample", timed)
    try:
        out = inner.run(ctx)
    finally:
        restore()
        restore_cases()
    # the window's calls: the first ones to start after it opened, one a
    # step (the set-up's step comes before, the profiled step after)
    layer = out["layer"]
    steps = layer["spans"].times.get("step", [])
    secs = [s for t, s in zip(starts, spans.times["denoise"])
            if t >= out["t_window_start"]][:len(steps)]
    if steps and len(secs) == len(steps):
        layer["denoise_ms"] = 1e3 * sum(secs) / len(steps)
        layer["denoise_flops"] = denoise_flops(
            ns, ctx.config, int(ctx.size("batch", ctx.workload["batch"])))
    return out

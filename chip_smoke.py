#!/usr/bin/env python3
"""Drive the PyTorch port (sicnav_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; each prints one line with its own seconds:

1. device   the card's name, the device count and its power limit.
2. build    nvcc builds the hand-written kernels (csrc/*.cu) into one library.
3. kernels  every kernel against its plain PyTorch version on the same
            inputs, at the test shapes and the main path's shapes, with the
            tolerance stated, on inputs where every term of the kernel's sum
            carries weight; the device time of one call (CUDA events, median
            of 100), and the median time of a synchronized call on the
            host's clock (the host overhead a caller pays).
4. slice    the main path: one 60-step hallway-bottleneck episode (host
            case 0, shipped env defaults) through rollout_episode_stateful.
            Every step pushes the human positions into the forecaster, serves
            a JMID forecast at the shipped hallway predictor's width (weights
            drawn from a seed; 48 samples, DDIM stride 2, KDE top 10), then
            DWA acts. Every forecast is checked; every kernel must have been
            launched on this path (launch counts are reset just before it),
            and is held again against its plain version on each input the
            path handed it.
5. cross    one forecast's samples and one env step on the card against the
            same on the CPU, with the same weights and noise.
6. profile  torch.profiler over three more control steps: the device's busy
            share and the kernels that take the most device time.

Then a JSON line listing every kernel, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; without a
CUDA device it exits 1 at once.
"""

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
KDE_TOL = 2e-4          # rtol = atol, the kernel's tolerance against its plain version
KDE_SHAPES = [(1, 7, 2), (3, 20, 24), (5, 33, 12)]      # tests/test_kde_pallas.py
MAIN_KDE_SHAPE = (8, 48, 16)    # joint ranking: G = horizon, D = 2 * max_humans
IMID_KDE_SHAPE = (64, 48, 2)    # iMID ranking: G = 8 * max_humans
# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 rate outside the
# tensor cores (the kernel's type), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[{self.name}] done in {time.perf_counter() - self.t0:.2f} s")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, n=100, chunk=10, warmup=20):
    """Device time of one call of ``fn``: the median, over ``n`` calls, of
    the time between a CUDA event recorded before the call and one after.

    The calls are queued ``chunk`` at a time behind a sleep kernel that
    outlasts their queuing, so the card never waits on the host between two
    events and the host's overhead stays out of the time. The chunk is
    small: with 100 calls of a plain version of ~20 kernels queued at once,
    the card caught up with the host behind a sleep of 300 ms, as if the
    host blocks once too many launches are pending. While a chunk is queued,
    torch's sync check is set to raise, so a call that waits for the card
    names itself; a sleep that still ends first is retried once, longer,
    then raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunk):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    while len(times) < n:
        for margin in (3, 12):
            starts = [torch.cuda.Event(enable_timing=True) for _ in range(chunk)]
            ends = [torch.cuda.Event(enable_timing=True) for _ in range(chunk)]
            slept = torch.cuda.Event()
            torch.cuda._sleep(int(sleep_cycles_per_ms() *
                                  (margin * queue_ms + 2)))
            slept.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for a, b in zip(starts, ends):
                    a.record()
                    fn()
                    b.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ahead = not slept.query()
            torch.cuda.synchronize()
            if ahead:
                times += [a.elapsed_time(b) for a, b in zip(starts, ends)]
                break
        else:
            raise RuntimeError(f"events_ms: the card caught up with the host "
                               f"twice (queuing {chunk} calls took "
                               f"{queue_ms:.2f} ms unsynced)")
    return statistics.median(times)


@functools.cache
def sleep_cycles_per_ms():
    """Clock cycles per millisecond of ``torch.cuda._sleep``, measured once."""
    cycles = 10 ** 7
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def call_ms(fn, n=200, warmup=20):
    """Median wall time of one call of ``fn`` as a caller sees it: host
    overhead and launch included, synchronized after each call. It is the
    "per call with host" figure beside each device time in PERF.md."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def kde_bound_ms(G, S, D):
    """Least time for the KDE function: each input read once and the output
    written once, or the float32 operations the function needs, whichever
    takes longer. The Gram is symmetric, so S(S+1)/2 dot products of 2D
    operations (its diagonal gives |y|^2); each of the S(S-1)/2 unordered
    pairs then takes 6 (distance 3, clamp, scale, exp) and adds its term to
    two rows (2); each row ends with a log and the shift by -log_Z (2). No
    running max is needed: d2 >= 0 and d_ii = 0, so the self term is each
    row's largest."""
    bytes_ = 4 * (G * S * D + G + G * S)
    ops = G * (S * (S + 1) * D + 4 * S * (S - 1) + 2 * S)
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kde_inputs(G, S, D, gen):
    """KDE inputs on which every term of the sum carries weight: samples at
    a spread of 2/sqrt(D) per coordinate, so pair distances are of order 1
    at every D (at a spread of order 1 and D = 16 every pair term would be
    below 1e-22, and a kernel that dropped them would still agree)."""
    y = (2.0 / math.sqrt(D)) * torch.randn((G, S, D), generator=gen,
                                           device="cuda")
    z = 1 + 4 * torch.rand((G,), generator=gen, device="cuda")
    return y, z


def pair_share(z, out):
    """Share of each row's sum that the pairs j != i carry: the self term
    is exp(-log_Z), so it is 1 - exp(-log_Z - out)."""
    return 1 - torch.exp(-z[:, None] - out)


def check_kde(K, y, z):
    """The kernel against its plain version on one input; max abs error."""
    got = K.kde_loglik(y, z)
    want = K.kde_loglik_plain(y, z)
    torch.testing.assert_close(got, want, rtol=KDE_TOL, atol=KDE_TOL)
    return (got - want).abs().max().item(), pair_share(z, want)


def phase_kernels(K):
    """KDE kernel vs plain version; returns its JSON entry (launches later)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    timings = {}
    for G, S, D in KDE_SHAPES + [MAIN_KDE_SHAPE, IMID_KDE_SHAPE]:
        y, z = kde_inputs(G, S, D, gen)
        err, share = check_kde(K, y, z)
        # the check must see the pair terms: most rows get >10 % from them
        weighted = (share > 0.1).float().mean().item()
        assert weighted >= 0.75, (G, S, D, weighted)
        max_err = max(max_err, err)
        ms = events_ms(lambda: K.kde_loglik(y, z))
        plain_ms = events_ms(lambda: K.kde_loglik_plain(y, z))
        call = call_ms(lambda: K.kde_loglik(y, z))
        plain_call = call_ms(lambda: K.kde_loglik_plain(y, z))
        timings[(G, S, D)] = (ms, plain_ms)
        bound, _ = kde_bound_ms(G, S, D)
        log(f"  kde_loglik G={G} S={S} D={D}: max_abs_err {err:.3e} "
            f"(bound rtol=atol={KDE_TOL}); pair share median "
            f"{share.median().item():.3f}, {100 * weighted:.0f} % of rows "
            f"over 0.1; device (events, median of 100): kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.4f} us; per call with host: kernel "
            f"{call * 1e3:.2f} us, plain {plain_call * 1e3:.2f} us")
    ms, plain_ms = timings[MAIN_KDE_SHAPE]
    bound, bound_by = kde_bound_ms(*MAIN_KDE_SHAPE)
    return {"name": "kde_loglik", "route": "cuda",
            "source": "sicnav_tpu_torch/csrc/kde.cu",
            "replaces": "sicnav_tpu/ops/kde_pallas.py:33",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def check_live_kde(K, ranked):
    """The kernel on every input the main path handed it, against the plain
    version in float64. On these inputs the float32 plain version is no
    reference: the reference's uncentred whitening puts |y|^2 near 1e9,
    where the Gram form's rounding (up to a few hundred in d2) can swallow
    the self term, d_ii = 0, that sets each row. Its error is printed."""
    err = plain_err = 0.0
    shares = []
    for preds, bw in ranked:
        y, z = K.kde_whiten(preds, bw)
        exact = K.kde_loglik_plain(y.double(), z.double())
        got = K.kde_loglik(y, z).double()
        torch.testing.assert_close(got, exact, rtol=KDE_TOL, atol=KDE_TOL)
        err = max(err, (got - exact).abs().max().item())
        plain = K.kde_loglik_plain(y, z).double()
        plain_err = max(plain_err, (plain - exact).abs().max().item())
        shares.append(pair_share(z.double(), exact).flatten())
    share = torch.cat(shares)
    log(f"  kde_loglik on the path's {len(ranked)} inputs {tuple(y.shape)}: "
        f"max_abs_err {err:.3e} against the float64 plain version (bound "
        f"rtol=atol={KDE_TOL}); the float32 plain version's {plain_err:.3e}; "
        f"|y|^2 up to {(y * y).sum(-1).max().item():.3e} (last input); pair "
        f"share median {share.median().item():.3e}, max "
        f"{share.max().item():.3e}")


def make_model(cfg, device):
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    torch.manual_seed(SEED)
    model = JMIDModel(cfg, device="cpu")
    if device != "cpu":
        twin = JMIDModel(cfg, device=device)
        twin.load_state_dict(model.state_dict())
        model = twin
    return model


def check_forecast(fc, lw, H, k, F):
    assert tuple(fc.shape) == (H, k, F + 1, 2), tuple(fc.shape)
    assert tuple(lw.shape) == (H, k), tuple(lw.shape)
    assert bool(torch.isfinite(fc).all()) and bool(torch.isfinite(lw).all())
    lse = torch.logsumexp(lw.double(), dim=-1)
    assert float(lse.abs().max()) < 1e-4, float(lse.abs().max())


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_slice(K, device="cuda", mcfg=None, max_steps=None):
    """The main path. ``device``, ``mcfg`` and ``max_steps`` exist only for
    tests/test_torch_slice.py::test_chip_smoke_main_path_rehearsal, which
    runs it small on the CPU; the script itself uses the defaults."""
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion import kde as KDE
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.rollout import rollout_episode_stateful
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.policies.dwa import dwa_policy

    cfg = EnvConfig()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    if mcfg is None:
        mcfg = ModelConfig(context_dim=128, tf_layer=2)  # jmid_hallway widths
    if max_steps is None:
        max_steps = int(round(cfg.time_limit / cfg.dt))
    model = make_model(mcfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    state = crowd_sim.reset_host(cfg, 0, device=device)
    fstate = FC.init_state(cfg.max_humans, fcfg, device=device)

    times = {"env": [], "forecast": [], "dwa": []}
    served = []
    last = [None]

    def step_fn(state, fstate):
        _sync(device)
        t0 = time.perf_counter()
        if last[0] is not None:
            times["env"].append(t0 - last[0])
        fstate = FC.update_state_hists(fstate, state, fcfg)
        fc, lw = FC.predict_ret_best(model, fstate, state, fcfg, generator=gen)
        _sync(device)
        t1 = time.perf_counter()
        action = dwa_policy(state, cfg)
        _sync(device)
        t2 = time.perf_counter()
        times["forecast"].append(t1 - t0)
        times["dwa"].append(t2 - t1)
        served.append((fc, lw))
        last[0] = t2
        return action, fstate

    # keep the samples of every ranking on the path, to hold the kernel
    # against its plain version on the same inputs afterwards
    fused, ranked = KDE.kde_loglik_fused, []

    def kept(preds, bandwidth):
        ranked.append((preds, bandwidth))
        return fused(preds, bandwidth)

    KDE.kde_loglik_fused = kept
    K.kde_loglik.launches = 0
    try:
        t0 = time.perf_counter()
        final, stats = rollout_episode_stateful(state, fstate, step_fn, cfg,
                                                max_steps)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        KDE.kde_loglik_fused = fused
    launches = K.kde_loglik.launches

    for fc, lw in served:
        check_forecast(fc, lw, cfg.max_humans, fcfg.num_ret_samples,
                       fcfg.horizon)
    assert len(served) == max_steps
    if torch.device(device).type == "cuda":
        assert launches == len(served), (launches, len(served))
    assert bool(torch.isfinite(final.h_pos).all())
    s = {k: (v.item() if v.dim() == 0 else v.tolist())
         for k, v in stats._asdict().items()}
    log(f"  episode (case 0, {max_steps} steps): success={s['success']} "
        f"timeout={s['timeout']} nav_time={s['nav_time']:.2f} s "
        f"collision_steps={s['collision_steps']} "
        f"wall_collision_steps={s['wall_collision_steps']} "
        f"frozen_steps={s['frozen_steps']} min_dist={s['min_dist']:.3f} "
        f"live_steps={s['steps']} total_reward={s['total_reward']:.3f}")
    for part, xs in times.items():
        log(f"  {part}: median {statistics.median(xs) * 1e3:.2f} ms, "
            f"p90 {pct(xs, 0.9) * 1e3:.2f} ms over {len(xs)} steps")
    log(f"  episode wall {wall:.2f} s; {len(served)} forecasts, "
        f"{launches} kde_loglik launches")
    if torch.device(device).type == "cuda":
        check_live_kde(K, ranked)
    return model, launches


def phase_cross(model_gpu, device="cuda"):
    """The card against the CPU on one forecast's samples and one env step.
    ``device`` is for the CPU rehearsal only (see ``phase_slice``)."""
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.policies.dwa import dwa_policy

    cfg = EnvConfig()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    model_cpu = make_model(model_gpu.cfg, "cpu")
    results = {}
    for dev, model in (("cpu", model_cpu), ("card", model_gpu)):
        dev = device if dev == "card" else dev
        state = crowd_sim.reset_host(cfg, 0, device=dev)
        fstate = FC.init_state(cfg.max_humans, fcfg, device=dev)
        for _ in range(3):
            fstate = FC.update_state_hists(fstate, state, fcfg)
            state, _, _ = crowd_sim.step_masked(state, dwa_policy(state, cfg),
                                                cfg)
        fstate = FC.update_state_hists(fstate, state, fcfg)
        batch = FC._scene_batch_from_hist(fstate, state, fcfg)
        x_T = torch.randn((fcfg.num_samples * cfg.max_humans, fcfg.horizon, 2),
                          generator=torch.Generator().manual_seed(SEED + 1))
        samples = model.sample(batch, fcfg.num_samples, x_T=x_T.to(dev),
                               stride=fcfg.ddim_stride)
        results[dev] = (state, samples.cpu())
    (s_cpu, x_cpu), (s_gpu, x_gpu) = results["cpu"], results[device]
    # env: float32 elementwise math on both; a few ulp on values of order 1
    for name in ("r_pos", "r_vel", "h_pos", "h_vel"):
        torch.testing.assert_close(getattr(s_gpu, name).cpu(),
                                   getattr(s_cpu, name), rtol=0, atol=1e-5)
    # JMID: 50 float32 passes of the full-width denoiser; cuBLAS and the CPU
    # sum in other orders, about 1e-5 per pass on values of order 1
    err = (x_gpu - x_cpu).abs().max().item()
    log(f"  env state card vs CPU within 1e-5 after 3 steps; forecast "
        f"samples max_abs_err {err:.3e} (bound 1e-3)")
    assert err < 1e-3, err


def phase_profile(model, steps=3):
    """Where a control step's time goes on the card: torch.profiler over
    ``steps`` steps of the loop after two warm-up steps. Prints the device's
    busy share of the window and the kernels that take the most device time.
    The launches here are outside the main path's count."""
    from torch.profiler import ProfilerActivity, profile
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.policies.dwa import dwa_policy

    cfg = EnvConfig()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = crowd_sim.reset_host(cfg, 0, device="cuda")
    fstate = FC.init_state(cfg.max_humans, fcfg, device="cuda")

    def control_step(state, fstate):
        fstate = FC.update_state_hists(fstate, state, fcfg)
        FC.predict_ret_best(model, fstate, state, fcfg, generator=gen)
        state, _, _ = crowd_sim.step_masked(state, dwa_policy(state, cfg), cfg)
        return state, fstate

    for _ in range(2):
        state, fstate = control_step(state, fstate)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, fstate = control_step(state, fstate)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    if busy_us <= 0:
        log("  profiler saw no device time: busy share not measured")
        return
    log(f"  {steps} control steps: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{n_launch} kernel launches ({n_launch / steps:.0f} per step)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d} x "
            f"{e.key[:90]}")
    kde = [e for e in kernels if "kde_loglik_kernel" in e.key]
    for e in kde:
        log(f"  kde_loglik_kernel: {e.count} launches, "
            f"{e.self_device_time_total / e.count:.2f} us each on the device")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sicnav_tpu_torch.ops import build
    from sicnav_tpu_torch.ops import kde_cuda as K

    t_start = time.perf_counter()
    with Phase("device"):
        smi = nvidia_smi()
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        log(f"  {name}, {count} device(s); nvidia-smi: {smi}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
    with Phase("build"):
        t0 = time.perf_counter()
        lib = build.build_library()
        build.load_library()
        log(f"  {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
        for line in build.build_log.strip().splitlines():
            log(f"  nvcc: {line}")
    with Phase("kernels"):
        entry = phase_kernels(K)
    with Phase("slice"):
        model, launches = phase_slice(K)
        entry["launches"] = launches
    with Phase("cross"):
        phase_cross(model)
    with Phase("profile"):
        phase_profile(model)
    log(f"total {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

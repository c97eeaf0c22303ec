#!/usr/bin/env python3
"""Drive the PyTorch port (sicnav_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; each prints one line with its own seconds:

1. device   the card's name, the device count and its power limit.
2. build    nvcc builds the hand-written kernels (csrc/*.cu) into one library;
            ptxas's registers for each kernel, and no kernel may spill.
3. kernels  every kernel against its plain PyTorch version on the same
            inputs, at the test shapes, a ragged shape and the main path's
            shapes, with the tolerance stated, on inputs where every term of
            the kernel's sum carries weight, and at the main path's shape
            far from the origin, as the path's own inputs lie, against the
            plain version in float64; the device time of one call (CUDA
            events, median of 100), and the median time of a synchronized
            call on the host's clock (the host overhead a caller pays).
4. slice    the first slice's path: one 60-step hallway-bottleneck episode
            (host case 0, shipped env defaults: 3 humans in 8 slots) through
            rollout_episode_stateful. Every step pushes the human positions
            into the forecaster, serves a JMID forecast at the shipped
            hallway predictor's width (weights drawn from a seed; 48
            samples, DDIM stride 2, KDE top 10), then DWA acts. Every
            forecast is checked; the kernel must have been launched on this
            path (launch counts are reset just before it), and is held again
            against its plain version on each input the path handed it.
5. mpc      the main path: the SICNav-Diffusion closed loop at the
            definitive protocol (hallway bottleneck, 3 ORCA-plus humans in 3
            slots starting at once, 30 s; the trained jmid_hallway weights
            from weights/jmid_hallway.npz; the bilevel MPC with the RA-L
            capsule robot, acados slacks, close-to-preds, door-yield, wall
            margin 0.10, IPMSettings(n_iter=30)), through
            sicnav_diffusion.make_policy and rollout_episode_stateful, for
            MPC_STEPS of the episode's 122 (the robot reached its goal at
            step 18 on the card; more steps would only rerun the MPC on the
            frozen state, at 6-11 s a step). Every action, IPMInfo and
            forecast is checked; the kernel must have been launched once
            per step and is held against its plain version on each input;
            it prints the env / forecast / MPC ms per step (median, p90)
            and the share of solves the cascade accepted.
6. cross    one forecast's samples and one env step on the card against the
            same on the CPU, with the same weights and noise; MPC control
            step CROSS_STEP on both, on the same state, carry and served
            forecasts: one IPM iteration within CROSS_ITER_TOL; the whole
            step in float64, its action within CROSS_ACTION_TOL; the
            float32 step's action within CROSS_ACTION_F32_TOL.
7. profile  torch.profiler over three DWA-loop steps and over one MPC
            control step: the device's busy share, the launches per control
            step and the kernels that take the most device time.
8. batch    the main path at B = BATCH episodes: host cases 0..BATCH-1 of
            the protocol, the trained weights, IPMSettings(n_iter=30),
            through sicnav_diffusion.make_policy(batch=True) and
            rollout.batch_rollout_stateful, for BATCH_STEPS batched control
            steps. Every forecast and action is checked; the kernel must
            have been launched once per batched step, on (BATCH * 8, 48, 6),
            and is held against its plain version on each input. It prints
            env / forecast / MPC ms per batched step (median, p90), the
            episode-steps per second beside the mpc phase's B = 1 rate, the
            cascade's accept share and the peak device memory. Gate: control
            step CROSS_STEP of cases 0..GATE_CASES-1 in float64, batched once
            and unbatched once per case, from the same states, carries and
            served forecasts: cascade branches equal, actions within
            BATCH_ACTION_TOL except on a step that float64 rounding alone
            decides (phase_batch_gate), and every case within
            BATCH_ACTION_TOL at GATE_SHORT_ITERS IPM iterations. Then
            torch.profiler over one batched step: its
            launches (at most BATCH_LAUNCH_RATIO times the unbatched
            step's), busy share and top kernels.
9. harness  harness.evaluate_policy with the batched DWA policy over host
            cases 0..BATCH-1 of the protocol at the full 122 steps, one
            batch, with a progress file under build/; the summary and the
            wall time. Gate: a second call with the same progress file
            resumes the batch without stepping and returns the same summary.
10. train   scripts/train_jmid_torch.py's sim path at the shipped hallway
            predictor's widths (ModelConfig(context_dim=128, tf_layer=2),
            TrainConfig(batch_size=8, lr=1e-4)): TRAIN_SCENES device resets
            of 5 ORCA-plus humans, the 60-step ORCA-robot rollout and the
            examples (seconds, counts); mid.fit for TRAIN_EPOCHS epochs
            (train-step ms median and p90, seconds, loss and val ADE per
            epoch); one profiled step (launches, busy share, peak memory);
            one train step on the card against the CPU with the same
            weights, batch and noise, dropout 0 (loss TRAIN_LOSS_TOL, each
            gradient TRAIN_GRAD_TOL of its largest entry, parameters after
            Adam TRAIN_PARAM_TOL); eval_scene_full over every validation
            scene, one kernel launch each, on the card and on the CPU from
            the same noise (each metric's mean, the non-finite counts), the
            kernel held against its plain version on the sweep's inputs;
            the checkpoint saved, loaded into a fresh model and sampled
            bit-equal, then served for one forecast of the protocol env.
11. rl      the SARL and RGL baselines (rl_env: circle crossing, 3 ORCA
            humans, 15 s, unicycle robot). serve: greedy SARL and RGL from
            weights/{sarl,rgl}_200k.npz over host cases 0..RL_CASES-1 at
            the full 62 steps, one batch, through harness.evaluate_policy
            (summary, the batched control step's and the greedy action's
            ms, median and p90, one profiled batched step's launches and
            busy share); gate: the same cases on the
            CPU, step 0's Q within RL_Q_TOL and each case's outcome equal
            unless a near tie (top-two gap <= RL_TIE) first split the
            actions. train: train_rl_torch.py's path at the published
            widths, IL_EPISODES demonstrations, IL_EPOCHS epochs, then DQN
            at DQN_ENVS environments for DQN_COLLECT_STEPS collect steps
            (seconds, IL losses, collect- and train-step ms, env steps per
            second, the last history record); one profiled collect + train
            step (launches, busy share, peak memory); the host syncs of a
            collect + train step under torch's sync debug mode (the ORCA
            LP's one read and no other); one train step and one collect
            step card vs CPU (RL_TRAIN_TOL); the training checkpoint's
            round trip bit-equal. lookahead2: one make_q2_fn call on
            LOOKAHEAD2_ENVS environments (ms, launches). humans: one env
            step with SFM humans in the hallway bottleneck and one with
            linear humans in circle crossing, card vs CPU (RL_HUMANS_TOL).
            No kernel of the port is on this path (its launches: 0).
12. imid    the iMID family. data: IMID_ROLLOUTS crowds synthesized on the
            card by scripts/synthesize_ethucy_torch.py into ETH-format
            files (seconds, example counts). serve: weights/
            imid_eth_proof.npz (iMID, encoder 256, three layers of 512)
            through eval_prediction_torch.py --method mid --full on the
            first IMID_SERVE_SCENES windows of a held-out file, 20 samples:
            min-of-20, most-likely (the joint ranking and each agent's
            own), KDE-NLL, SADE / SFDE, non-finite counts, the kernel's
            launches (two per scene, on 16 x 8 groups of 2 and 8 groups of
            32) held against the plain version on each input, one scene's
            sampling latency (median, p90); one scene card vs CPU (context
            IMID_CTX_TOL, samples IMID_SAMPLE_TOL, each ranking's scores
            to float64 within IMID_LIK_TOL of their terms' scale, and its
            pick where the top two stand IMID_TIE apart, near ties
            counted);
            DDPM on the cosine schedule (flexibility 0.5, from zeros, the
            noise handed in) card vs CPU. recipe: train_jmid_torch.py
            --recipe ddim_p3_bs256_lr001_eth, one epoch at its widths and
            batch 256 on the synthesized train files (step ms median and
            p90), one profiled step (launches, busy share, peak memory),
            its host syncs, one step card vs CPU (TRAIN_* bounds). Then a
            class-conditioned JMID train step on the maneuver sim's typed
            scenes and a CVAETrajectron loss and prediction, card vs CPU.

13. observe the observation path, the plain controllers, the solver's
            introspection and the streaming controller, at the protocol.
            plain: plain SICNav-p through scripts/eval_suite_torch.py's
            config functions (--policy campc --privileged: campc.make_policy(
            batch=True), the RA-L robot, wall margin 0.05, door-yield off)
            under OBSERVE_NOISE observation noise with the Kalman filter
            inside it, cases 0..BATCH-1 as one batch for
            OBSERVE_PLAIN_STEPS timed steps at IPMSettings(n_iter=30) and
            a third, profiled one (launches, busy share): MPC ms per
            batched step (median, p90), the cascade's accept share; the
            float64 gate of the batch phase (batch_gate) on the filtered
            states of GATE_CASES cases at the last timed step. fused:
            the fused controller through the same script and wrappers,
            OBSERVE_FUSED_STEPS batched steps; the kernel launched once per step on (BATCH * 8, 48, 6)
            and held against its plain version on each input. debug:
            introspection.debug_solve_report of case 0's plain NLP at that
            step on the card and on the CPU from the same guess: the
            trace's first iteration within OBSERVE_DEBUG_TOL, the worst
            constraint class equal. stream: scripts/
            real_robot_loop_torch.py on host case STREAM_CASE for
            STREAM_SECONDS of wall clock at 10 Hz (its JSON line: ticks,
            latency p50 / p95, deadline misses); the kernel launched once
            per tick and once for the warm-up step.
14. tools   the INI configs, the single-episode runner, the traced suite
            audit and the control-step decomposition. config: configs/
            env.config and configs/policy.config through config.py
            (scenario, humans, robot_nx, hum_model, config_hash). simple:
            scripts/simple_test_torch.py --policy dwa from configs/
            env.config on hallway-bottleneck host case 0 to its end (the
            outcome, steps, wall time, --output_pickle under build/), then
            --policy sicnav_diffusion --checkpoint weights/jmid_hallway.npz
            --debug_pickle for TOOLS_DEBUG_STEPS control steps at 30 IPM
            iterations: the pickle's solves carry the reference's keys
            and finite iteration traces; the kernel launched once per
            step on (8, 48, 6) and held against its plain version on each
            input. audit: scripts/suite_audit_torch.py --policy
            sicnav_diffusion on TOOLS_AUDIT_CASES cases as one batch with
            a TOOLS_AUDIT_TIME s limit (6 traced batched steps, 30
            iterations) and a --resume_dir: its JSON, every collision and
            timeout episode in one class, its summary that of the batch
            file's stats, one launch per step on (8 * TOOLS_AUDIT_CASES,
            48, 6) held against the plain version; a second call with the
            same --resume_dir steps nothing and reports the same. bench:
            scripts/bench_control_step_torch.py's rows at the protocol's
            widths with TOOLS_BENCH_REPS calls each, kkt_dim the fused
            OCP's n_z + n_eq (TOOLS_KKT_DIM); the kernel on its forecast
            and fused rows held against the plain version.
15. mesh    the data-parallel mesh on torch.distributed, MESH_RANKS ranks
            sharing the card over gloo (NCCL only with a card per rank):
            the backend, the world size and each rank's device. native:
            the native ORCA oracle built by g++ into build/native/, and
            ops/orca on the card held to it on tests/test_native.py's 40
            agent and 40 wall scenes (ORCA_NATIVE_TOL per agent, at most
            ORCA_WALL_MISMATCHES walls over it). entry: entry()'s JMID
            forward on the card against the CPU (MESH_ENTRY_TOL). dryrun:
            entry.dryrun_multichip(MESH_RANKS) (env + DWA, a JMID train
            step, a SARL DQN step, a fleet CAMPC step). harness:
            harness.evaluate_policy(mesh=) of the fused controller (the
            protocol, the trained weights) over cases 0..MESH_CASES-1 as
            one batch, each rank stepping its share for MESH_TIME s (4
            steps) at MESH_IPM_ITERS IPM iterations, held to the
            one-process run at each rank's share as its batch (run here
            beside the ranks, and the dryrun beside both): every
            case's outcome counts equal, times within MESH_TIME_TOL; each
            rank's kernel launched once per step on (8 * share, 48, 6), its
            inputs held against the float64 plain version in the rank; the
            launches summed over the ranks. bench:
            scripts/bench_fleet_scaling_torch.py's rows at 1 and
            MESH_RANKS ranks (batch MESH_BENCH_BATCH, MESH_BENCH_ITERS IPM
            iterations, MESH_BENCH_REPS timed steps a row).

Phases 8 (batch, with its profiled step) and 14 (tools), and phases 12, 13
and 15 (imid, observe, mesh), run in two more processes (``chip_smoke.py
--late PHASES OUT``), started after phase 3 and run beside the others; their
lines are relayed behind their phases' names, and each writes the kernel's
launches on its paths, and what the batch phase measured, to OUT. Phase
``late`` waits for both (until LATE_DEADLINE_S from the start), takes the
launches in and holds the batched step's launches to the unbatched step's.
Each process resets the kernel's count just before each of its paths and
reads it just after; a failure in any process fails the run, and every
process started is ended before the script exits.

Then a JSON line listing every kernel, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero and prints no result; without a
CUDA device it exits 1 at once.
"""

import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
KDE_TOL = 2e-4          # rtol = atol, the kernel's tolerance against its plain version
KDE_SHAPES = [(1, 7, 2), (3, 20, 24), (5, 33, 12)]      # tests/test_kde_pallas.py
RAGGED_KDE_SHAPE = (2, 100, 3)  # S > 64 and not a multiple of 32, D odd
MAIN_KDE_SHAPE = (8, 48, 16)    # DWA slice's joint ranking: G = horizon, D = 2 * 8 slots
IMID_KDE_SHAPE = (64, 48, 2)    # iMID ranking: G = 8 * max_humans
PROTOCOL_KDE_SHAPE = (8, 48, 6)  # the protocol's joint ranking: 3 humans
PROTOCOL_IMID_SHAPE = (24, 48, 2)  # the protocol's iMID ranking
BATCH = 10              # episodes per batched control step (the reference's suites)
BATCH_KDE_SHAPE = (8 * BATCH, 48, 6)  # the batched joint ranking: B x horizon groups
# the validation sweep's joint ranking (eval_scene_full, 20 samples), one
# launch per scene: train_jmid's 5 humans, and 3
SWEEP_KDE_SHAPES = [(8, 20, 10), (8, 20, 6)]
BATCH_STEPS = 6         # batched control steps of the batch phase
GATE_CASES = 3          # cases of the batched-vs-unbatched float64 gate
# The batched step against the unbatched one in float64: the same NLPs in
# other kernels (batched products, cuBLAS's batched LU for cuSOLVER's);
# float32 would move the action by up to 1e-2, so the gate runs in float64.
# Some steps amplify even float64 rounding: at control step 2 of host case
# 0 (the batch's), the batched and unbatched solves agreed to 5e-14 of z
# after 3 IPM iterations, 1e-7 after 10 and 4e-2 after 30, and the same
# unbatched step moved its action by 2.1e-4 between the card and the CPU.
# Such a step (card and CPU unbatched more than BATCH_ACTION_TOL apart) is
# decided by rounding; there the batched action is held to
# CROSS_ACTION_F32_TOL, and at most one gate case may be such a step. Every
# case is also held to BATCH_ACTION_TOL, with no exception, on the same step
# cut to GATE_SHORT_ITERS IPM iterations, before rounding has grown.
BATCH_ACTION_TOL = 1e-6
GATE_SHORT_ITERS = 3
# a batched step's launches against the unbatched step's: vmap batches
# each op once for all episodes; a loop over episodes would make ~BATCH x
BATCH_LAUNCH_RATIO = 2.0
WEIGHTS = os.path.join(ROOT, "weights", "jmid_hallway.npz")
MPC_STEPS = 20          # control steps of the mpc phase (case 0 ends at step 18)
MPC_IPM_ITERS = 30      # the protocol's IPMSettings(n_iter=30)
CROSS_ITER_TOL = 1e-4   # one IPM iteration, card vs CPU, relative to max |z|
CROSS_STEP = 2          # the control step cross-checked: the robot turning
# The control step's action (v, r), card vs CPU. Thirty iterations of a
# nonconvex IPM that end unconverged carry float32 rounding, 1e-6 after one
# iteration, into the action: r moved by 1.2e-2 between 4 and 1 CPU
# threads at CROSS_STEP, and by 7.0e-3 between the card and the CPU. In
# float64 the same step moved by 1.6e-10 between thread counts, so the
# float64 step holds the card to the CPU's control step; r forced to 0
# would miss it by |r|, 2.3e-2 there. The float32 bound is a sanity bound
# above float32's reach (scripts/mpc_rounding_torch.py; PERF.md section 6).
CROSS_ACTION_TOL = 1e-6
CROSS_ACTION_F32_TOL = 2e-2
FAR_KDE_R2 = 1.2e9              # |y|^2 of the main path's whitened samples
# The train phase: train_jmid's sim data cut from 64 scenes to TRAIN_SCENES
# and the shipped predictor's 40 epochs to TRAIN_EPOCHS.
TRAIN_SCENES = 16
TRAIN_EPOCHS = 2
# One train step on the card against the CPU, same weights, batch and
# noise, dropout 0: float32 sums in other orders through the encoder's
# LSTMs, the denoiser and their backward passes.
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4   # of each gradient tensor's largest entry
TRAIN_PARAM_TOL = 1e-5  # after the clip and the Adam update
# The rl phase: the SARL and RGL baselines of the reference's RL
# configuration (rl_env), served from weights/{sarl,rgl}_200k.npz and
# trained by train_rl_torch.py's path at the published widths and the
# records' n_envs = 64, cut from 300 IL episodes, 100 IL epochs and
# 200,000 env steps.
RL_WEIGHTS = {name: os.path.join(ROOT, "weights", f"{name}_200k.npz")
              for name in ("sarl", "rgl")}
RL_CASES = 10
RL_Q_TOL = 1e-4         # step 0's Q-values, card vs CPU
RL_TIE = 1e-4           # a top-two Q gap at most this is a near tie
IL_EPISODES = 32
IL_EPOCHS = 5
DQN_ENVS = 64
DQN_COLLECT_STEPS = 100
LOOKAHEAD2_ENVS = 8
# one DQN train step and one collect step, card vs CPU; one env step with
# SFM or linear humans, card vs CPU
RL_TRAIN_TOL = 1e-5
RL_HUMANS_TOL = 1e-5
# The imid phase: the shipped ETH iMID checkpoint served on ETH-format
# data from the port's synthesizer (IMID_ROLLOUTS rollouts of 6 humans and
# the robot, 50 steps at dt 0.4, 15 % held out), eval_prediction's slicing
# (history 6, horizon 8, up to 16 agents), the first IMID_SERVE_SCENES
# windows of the first held-out file; then one epoch of its recipe at its
# widths and batch size on the rest.
IMID_WEIGHTS = os.path.join(ROOT, "weights", "imid_eth_proof.npz")
IMID_WIDTHS = dict(context_dim=256, tf_layer=3)
IMID_RECIPE = "ddim_p3_bs256_lr001_eth"
IMID_ROLLOUTS = 20
IMID_ROLLOUTS_PER_FILE = 10
IMID_SERVE_SCENES = 48
IMID_SAMPLES = 20
# its rankings: per agent 16 x 8 groups of 2 (at the recipe's horizon 12,
# 16 x 12), jointly 8 (12) groups of 2 x 16
IMID_KDE_SHAPES = [(128, 20, 2), (192, 20, 2), (8, 20, 32), (12, 20, 32)]
# one scene card vs CPU: the encoder's context, the samples from one start
# noise; each ranking's scores against float64 to IMID_LIK_TOL of their
# terms' scale (the sum over the horizon of each step's largest |log
# likelihood|; float32 rounds to about 3e-8 of it), its picks where the
# float64 top-two gap exceeds IMID_TIE
IMID_CTX_TOL = 1e-4
IMID_SAMPLE_TOL = 1e-3
IMID_LIK_TOL = 1e-6
IMID_TIE = 1e-5
# The observe phase: the observation path and the plain controller at the
# protocol (robustness table, BENCH_EXTRA.md:1447-1451): sigma = 0.05
# observation noise with the constant-velocity Kalman filter inside it,
# cases 0..BATCH-1 as one batch; the streaming controller for a short
# wall-clock replay. Cut to a few steps of 122 each.
OBSERVE_NOISE = 0.05
OBSERVE_PLAIN_STEPS = 2     # timed batched plain SICNav-p steps (+ 1 profiled)
OBSERVE_FUSED_STEPS = 2     # batched fused steps
OBSERVE_DEBUG_TOL = 1e-4    # the trace's first iteration, card vs CPU
STREAM_CASE = 3
STREAM_SECONDS = 0.3        # wall-clock replay at 10 Hz: 2-3 ticks
# The tools phase: the INI configs, the single-episode runner, the traced
# suite audit and the control-step decomposition, each cut to seconds.
TOOLS_DEBUG_STEPS = 2       # simple_test --policy sicnav_diffusion steps
TOOLS_AUDIT_CASES = 2       # suite_audit cases, one batch
TOOLS_AUDIT_TIME = 1.0      # s: 1.0 / 0.25 + 2 = 6 traced batched steps
TOOLS_BENCH_REPS = 2        # calls per bench_control_step row (CLI: 20)
TOOLS_KKT_DIM = 317         # n_z + n_eq of the protocol's fused OCP
MESH_RANKS = 2              # ranks of the mesh phase, sharing the card
MESH_CASES = 4              # protocol cases 0-3 through the sharded harness
MESH_TIME = 0.5             # s: 0.5 / 0.25 + 2 = 4 batched control steps
MESH_IPM_ITERS = GATE_SHORT_ITERS
MESH_TIME_TOL = 1e-5        # the sharded summary's times against one process
MESH_ENTRY_TOL = 1e-4       # entry()'s forward, card vs CPU
MESH_BENCH_BATCH = 4        # bench_fleet_scaling_torch.py at 1 and 2 ranks
MESH_BENCH_ITERS = 3
MESH_BENCH_REPS = 1
# The late phases run in two more processes, `chip_smoke.py --late PHASES
# OUT`, started once the kernels phase has timed the kernel on an idle card,
# beside the other phases: each process drives the card from a host core of
# its own, and the card is busy under 10 % of an MPC step (PERF.md
# section 5). The batch phase's launches per step are held to the unbatched
# step's in this process, once its late process has ended.
LATE_GROUPS = (("batch", "tools"), ("imid", "observe", "mesh"))
LATE_DEADLINE_S = 1140      # s from the start; the late processes end by then
ORCA_NATIVE_TOL = 2e-3      # tests/test_native.py: per agent
ORCA_WALL_MISMATCHES = 2    # tests/test_native.py: of the 40 wall scenes
DEBUG_KEYS = {"step", "trace", "info", "viol_sol", "viol_used", "used_guess",
              "sol_cost", "guess_cost", "slack_max", "worst"}
# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 rate outside the
# tensor cores (the kernel's type), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


_LOG_LOCK = threading.Lock()


def log(msg):
    # one write per line: the late process's relayed lines share stdout
    with _LOG_LOCK:
        sys.stdout.write(f"{msg}\n")
        sys.stdout.flush()


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
    names itself; a sleep that still ends first is retried twice, each time
    four times longer, then raises."""
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
        for margin in (3, 12, 48):
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
                               f"three times (queuing {chunk} calls took "
                               f"{queue_ms:.2f} ms unsynced)")
    return statistics.median(times)


@functools.cache
def sleep_cycles_per_ms():
    """Clock cycles per millisecond of ``torch.cuda._sleep``, measured once:
    the most of three measurements, after a sleep that wakes the card. A
    card that starts at a low clock reads few cycles per ms, and every later
    sleep, at the full clock, then ends several times sooner than asked
    (so the card caught up with the host on a fresh card's first shape)."""
    cycles = 10 ** 7
    torch.cuda._sleep(5 * cycles)
    rates = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        rates.append(cycles / a.elapsed_time(b))
    return max(rates)


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


def check_ptxas(text):
    """Print the registers of each kernel in nvcc's ``-Xptxas -v`` report;
    raise if one spills or keeps a stack frame (an array such as y_i that
    left the registers). A library built by an earlier run of the same
    sources leaves no report."""
    if not text:
        log("  ptxas: library built by an earlier run; no report")
        return
    rows, name, local = [], "", (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            local = (int(m.group(1)), int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append((name, int(m.group(1)), *local))
            local = (0, 0)
    assert rows, "no ptxas report in the build log"
    for name, regs, stack, spill in rows:
        m = re.search(r"kde_loglik_kernelILi(\d+)ELb([01])E", name)
        label = (f"kde_loglik_kernel D {'=' if m.group(2) == '1' else '<='} "
                 f"{m.group(1)}" if m else name)
        log(f"  ptxas: {label}: {regs} registers, {stack} bytes stack "
            f"frame, {spill} bytes spilled")
    local = [r for r in rows if r[2] or r[3]]
    assert not local, f"kernels use local memory: {local}"


def check_far_kde(K, gen):
    """The kernel at the main path's shape with |y|^2 near FAR_KDE_R2, as
    the path's uncentred whitened samples lie, against the plain version in
    float64 (the float32 plain version's Gram form loses hundreds in d2
    there; its error is printed); max abs error."""
    G, S, D = MAIN_KDE_SHAPE
    y, z = kde_inputs(G, S, D, gen)
    y = y + math.sqrt(FAR_KDE_R2 / D)
    exact = K.kde_loglik_plain(y.double(), z.double())
    got = K.kde_loglik(y, z).double()
    torch.testing.assert_close(got, exact, rtol=KDE_TOL, atol=KDE_TOL)
    share = pair_share(z.double(), exact)
    weighted = (share > 0.1).double().mean().item()
    assert weighted >= 0.75, weighted
    err = (got - exact).abs().max().item()
    plain_err = (K.kde_loglik_plain(y, z).double() - exact).abs().max().item()
    log(f"  kde_loglik G={G} S={S} D={D}, |y|^2 up to "
        f"{(y * y).sum(-1).max().item():.3e}: max_abs_err {err:.3e} against "
        f"the float64 plain version (bound rtol=atol={KDE_TOL}); the float32 "
        f"plain version's {plain_err:.3e}; pair share median "
        f"{share.median().item():.3f}, {100 * weighted:.0f} % of rows over "
        f"0.1")
    return err


def phase_kernels(K):
    """KDE kernel vs plain version; returns its JSON entry (launches later)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    timings = {}
    for G, S, D in KDE_SHAPES + [RAGGED_KDE_SHAPE, MAIN_KDE_SHAPE,
                                 IMID_KDE_SHAPE, PROTOCOL_KDE_SHAPE,
                                 PROTOCOL_IMID_SHAPE, BATCH_KDE_SHAPE,
                                 *SWEEP_KDE_SHAPES, *IMID_KDE_SHAPES]:
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
    max_err = max(max_err, check_far_kde(K, gen))
    # the main path is now the batched protocol loop: its ranking's shape;
    # the one-episode loop's beside it
    per_shape = {}
    for shape in (BATCH_KDE_SHAPE, PROTOCOL_KDE_SHAPE, *SWEEP_KDE_SHAPES,
                  *IMID_KDE_SHAPES):
        ms, plain_ms = timings[shape]
        bound, bound_by = kde_bound_ms(*shape)
        per_shape["x".join(map(str, shape))] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by}
    main = per_shape["x".join(map(str, BATCH_KDE_SHAPE))]
    return {"name": "kde_loglik", "route": "cuda",
            "source": "sicnav_tpu_torch/csrc/kde.cu",
            "replaces": "sicnav_tpu/ops/kde_pallas.py:33",
            "launches": None, "max_abs_err": max_err, **main,
            "library_ms": None, "per_shape": per_shape}


def check_live_kde(K, ranked):
    """The kernel on every input the main path handed it, against the plain
    version in float64. The reference's uncentred whitening puts |y|^2 near
    1e9 there, where a float32 Gram-form distance (the reference's) would
    miss the self term d_ii = 0 by hundreds; the plain version takes the
    distance in difference form, as the kernel does, and its float32 error
    is printed beside the kernel's. Groups whose log-likelihoods are not all
    finite (a whitening singular in float32) are counted and printed; there
    the kernel must give what the plain version gives (NaN for NaN).
    Returns that count of groups."""
    err = plain_err = 0.0
    shares, bad = [], 0
    for preds, bw in ranked:
        y, z = K.kde_whiten(preds, bw)
        exact = K.kde_loglik_plain(y.double(), z.double())
        got = K.kde_loglik(y, z).double()
        ok = torch.isfinite(got).all(dim=-1)
        bad += int((~ok).sum())
        torch.testing.assert_close(got, exact, rtol=KDE_TOL, atol=KDE_TOL,
                                   equal_nan=True)
        if not bool(ok.any()):
            continue
        err = max(err, (got[ok] - exact[ok]).abs().max().item())
        plain = K.kde_loglik_plain(y, z).double()
        plain_err = max(plain_err, (plain[ok] - exact[ok]).abs().max().item())
        shares.append(pair_share(z.double(), exact)[ok].flatten())
    share = torch.cat(shares) if shares else torch.full((1,), math.nan)
    log(f"  kde_loglik on the path's {len(ranked)} inputs {tuple(y.shape)}: "
        f"max_abs_err {err:.3e} against the float64 plain version (bound "
        f"rtol=atol={KDE_TOL}); the float32 plain version's {plain_err:.3e}; "
        f"|y|^2 up to {(y * y).sum(-1).max().item():.3e} (last input); pair "
        f"share median {share.median().item():.3e}, max "
        f"{share.max().item():.3e}; groups with non-finite likelihoods: "
        f"{bad}")
    return bad


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


def protocol_env():
    """The definitive protocol's environment: hallway bottleneck, 3 ORCA-plus
    humans in 3 slots that start at once, 30 s, unicycle robot."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                     human_num=3, max_humans=3, starts_moving=0,
                     time_limit=30, robot_kinematics="unicycle")


def trained_model(device):
    """The trained hallway JMID predictor at its shipped widths, from the
    converted weights in the checkout (scripts/convert_jmid_torch.py)."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), device=device)
    model.load_state_dict(load_npz(WEIGHTS))
    return model


def _wrap(module, name, wrapper):
    """Replace module.name by wrapper(original); returns the restorer."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    return lambda: setattr(module, name, orig)


def phase_mpc(K, device="cuda", max_steps=None, measured=None):
    """The main path: the SICNav-Diffusion closed loop at the definitive
    protocol, through sicnav_diffusion.make_policy and
    rollout_episode_stateful, with the trained weights. ``device`` and
    ``max_steps`` exist for tests/test_torch_slice.py's CPU rehearsal.
    Returns (ocp, model, settings, (k, state, carry, served forecasts) of
    step k = CROSS_STEP or the last, launches); puts the median seconds of
    a control step with its env step into ``measured["b1_step_s"]``."""
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion import kde as KDE
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.rollout import rollout_episode_stateful
    from sicnav_tpu_torch.mpc import ipm
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cfg = protocol_env()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    settings = ipm.IPMSettings(n_iter=MPC_IPM_ITERS)
    max_steps = MPC_STEPS if max_steps is None else max_steps
    model = trained_model(device)
    ocp, policy_fn = SD.make_policy(cfg, model, fcfg=fcfg, settings=settings,
                                    device=device)
    state = crowd_sim.reset_host(cfg, 0, device=device)
    carry = SD.init_carry(ocp, cfg.max_humans, fcfg, seed=SEED)

    times = {"env": [], "forecast": [], "mpc": []}
    served, infos, ranked, accepted, actions = [], [], [], [], []
    last, record = [None], []

    def timed_forecast(orig):
        def fn(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            _sync(device)
            times["forecast"].append(time.perf_counter() - t0)
            served.append(out)
            return out
        return fn

    def kept_solve(orig):
        def fn(*args, **kwargs):
            out = orig(*args, **kwargs)
            infos.append(out[1])
            return out
        return fn

    def kept_kde(orig):
        def fn(preds, bandwidth):
            ranked.append((preds, bandwidth))
            return orig(preds, bandwidth)
        return fn

    def step_fn(state, carry):
        _sync(device)
        t0 = time.perf_counter()
        if last[0] is not None:
            times["env"].append(t0 - last[0])
        n_fc = len(times["forecast"])
        action, new_carry = policy_fn(state, carry)
        _sync(device)
        t1 = time.perf_counter()
        assert len(times["forecast"]) == n_fc + 1
        times["mpc"].append(t1 - t0 - times["forecast"][-1])
        accepted.append(new_carry.mpc.prev_ok)
        actions.append(action)
        if len(actions) <= CROSS_STEP + 1:
            record[:] = [len(actions) - 1, state, carry.mpc, served[-1]]
        last[0] = t1
        return action, new_carry

    restore = [_wrap(FC, "predict_ret_best", timed_forecast),
               _wrap(ipm, "solve", kept_solve),
               _wrap(KDE, "kde_loglik_fused", kept_kde)]
    K.kde_loglik.launches = 0
    try:
        t0 = time.perf_counter()
        final, stats = rollout_episode_stateful(state, carry, step_fn, cfg,
                                                max_steps)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        for r in restore:
            r()
    launches = K.kde_loglik.launches

    assert len(served) == max_steps == len(infos) == len(actions)
    for fc, lw in served:
        check_forecast(fc, lw, cfg.max_humans, fcfg.num_ret_samples,
                       fcfg.horizon)
    for a in actions:
        assert tuple(a.shape) == (2,) and bool(torch.isfinite(a).all()), a
    for info in infos:
        for name, x in info._asdict().items():
            assert bool(torch.isfinite(x.float()).all()), (name, x)
    if torch.device(device).type == "cuda":
        assert launches == len(served), (launches, len(served))
    assert bool(torch.isfinite(final.h_pos).all())
    s = {k: (v.item() if v.dim() == 0 else v.tolist())
         for k, v in stats._asdict().items()}
    acc = torch.stack(accepted).float()
    eq = torch.stack([i.eq_viol for i in infos])
    log(f"  protocol episode (host case 0, {max_steps} of 122 steps, "
        f"IPM {settings.n_iter} iterations, trained jmid_hallway): "
        f"success={s['success']} collision_steps={s['collision_steps']} "
        f"wall_collision_steps={s['wall_collision_steps']} "
        f"frozen_steps={s['frozen_steps']} yield_steps={s['yield_steps']} "
        f"min_dist={s['min_dist']:.3f} live_steps={s['steps']} "
        f"robot at ({final.r_pos[0].item():.3f}, {final.r_pos[1].item():.3f})")
    for part, xs in times.items():
        log(f"  {part}: median {statistics.median(xs) * 1e3:.2f} ms, "
            f"p90 {pct(xs, 0.9) * 1e3:.2f} ms over {len(xs)} steps")
    step_ms = [sum(x) for x in zip(times["forecast"], times["mpc"])]
    log(f"  control step (forecast + MPC): median "
        f"{statistics.median(step_ms) * 1e3:.2f} ms; episode wall {wall:.2f} s")
    if measured is not None:
        measured["b1_step_s"] = (statistics.median(step_ms) +
                                 statistics.median(times["env"]))
    log(f"  cascade accepted the solution on {int(acc.sum().item())} of "
        f"{len(accepted)} steps ({100 * acc.mean().item():.1f} %); eq_viol "
        f"median {eq.median().item():.3e}, max {eq.max().item():.3e}; "
        f"{launches} kde_loglik launches in {len(served)} forecasts")
    if torch.device(device).type == "cuda":
        check_live_kde(K, ranked)
    return ocp, model, settings, record, launches


def _rel_err(got, want):
    return ((got.cpu().double() - want.cpu().double()).abs().max() /
            max(1.0, want.abs().max().item())).item()


def phase_cross_mpc(ocp, record, settings, device="cuda"):
    """One MPC control step on the card against the same step on the CPU:
    the same state, carry and served forecasts (the card's). One IPM
    iteration from the card's initial guess must agree within
    CROSS_ITER_TOL; the step's action within CROSS_ACTION_TOL in float64
    and CROSS_ACTION_F32_TOL in float32."""
    from sicnav_tpu_torch.env.crowd_sim import tree_map
    from sicnav_tpu_torch.mpc import campc as C
    from sicnav_tpu_torch.mpc import ipm
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
    from sicnav_tpu_torch.mpc.ocp import OCP

    cfg = protocol_env()
    k, state, carry, (fc, lw) = record
    ocp_cpu = OCP(ocp.cfg, device="cpu")
    sides = {"card": (ocp, state, carry, fc, lw),
             "cpu": (ocp_cpu,) + tuple(tree_map(lambda x: x.cpu(), x)
                                       for x in (state, carry, fc, lw))}
    one = dataclasses.replace(settings, n_iter=1)

    def f64(x):
        return x.double() if x.is_floating_point() else x

    z0, out = None, {}
    for name, (o, st, ca, f, w) in sides.items():
        view, mid, logw0, intent = SD.mpc_inputs(o, st, f, w)
        params, _, (f_fn, c_fn) = C.step_problem(o, view, ca, cfg, mid,
                                                 logw0, intent)
        if z0 is None:
            z0 = C._select_guess(o, ca, params)
        z1, _ = ipm.solve(f_fn, c_fn, z0.to(st.r_pos.device), one)
        t0 = time.perf_counter()
        action, _, aux = SD.act_on_forecasts(o, st, ca, f, w, cfg, settings,
                                             aux=True)
        _sync(st.r_pos.device)
        ms = (time.perf_counter() - t0) * 1e3
        action64, _, aux64 = SD.act_on_forecasts(
            o, *(tree_map(f64, x) for x in (st, ca, f, w)), cfg, settings,
            aux=True)
        assert action64.dtype == torch.float64, action64.dtype
        out[name] = dict(z1=z1, action=action.cpu().double(),
                         action64=action64.cpu(), ms=ms,
                         eq=aux.eq_viol.item(), eq64=aux64.eq_viol.item(),
                         guess=bool(aux.use_guess),
                         guess64=bool(aux64.use_guess))
    card, cpu = out["card"], out["cpu"]
    it_err = _rel_err(card["z1"], cpu["z1"])
    act_err = (card["action"] - cpu["action"]).abs().max().item()
    act64_err = (card["action64"] - cpu["action64"]).abs().max().item()
    log(f"  MPC control step {k}: one IPM iteration from the same "
        f"guess, card vs CPU max err {it_err:.3e} of max(1, |z|) (bound "
        f"{CROSS_ITER_TOL}); float64 step's action: card "
        f"{card['action64'].tolist()}, CPU {cpu['action64'].tolist()}, max "
        f"abs err {act64_err:.3e} (bound {CROSS_ACTION_TOL}); float32 step's "
        f"action: card {card['action'].tolist()}, CPU "
        f"{cpu['action'].tolist()}, max abs err {act_err:.3e} (bound "
        f"{CROSS_ACTION_F32_TOL}); eq_viol {card['eq']:.3e} on the card, "
        f"{cpu['eq']:.3e} on the CPU (float64 {card['eq64']:.3e}, "
        f"{cpu['eq64']:.3e}); float32 MPC step {card['ms']:.1f} ms on the "
        f"card, {cpu['ms']:.1f} ms on the CPU")
    assert it_err <= CROSS_ITER_TOL, it_err
    assert card["guess64"] == cpu["guess64"], (card, cpu)
    assert act64_err <= CROSS_ACTION_TOL, act64_err
    assert act_err <= CROSS_ACTION_F32_TOL, act_err


def device_events(prof):
    """(name, duration in us) of every device activity a profile recorded,
    read from the raw trace: parsing ~10^6 events into torch.profiler's
    Python tree (key_averages) took minutes on the card's host."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def phase_profile_mpc(ocp, model, settings, steps=1):
    """Where an MPC control step's time goes on the card: torch.profiler
    (device activity only) over ``steps`` steps of the protocol loop after
    one warm-up step. Prints the device's busy share, the launches per
    control step and the kernels that take the most device time; returns
    the launches per step."""
    from torch.profiler import ProfilerActivity, profile
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cfg = protocol_env()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    state = crowd_sim.reset_host(cfg, 0, device="cuda")
    carry = SD.init_carry(ocp, cfg.max_humans, fcfg, seed=SEED + 2)

    def control_step(state, carry):
        action, carry = SD.sicnav_diffusion_action(ocp, model, state, carry,
                                                   cfg, fcfg, settings)
        state, _, _ = crowd_sim.step_masked(state, action, cfg)
        return state, carry

    state, carry = control_step(state, carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, carry = control_step(state, carry)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy_us = sum(d for _, d in events)
    if busy_us <= 0:
        log("  profiler saw no device time: busy share not measured")
        return None
    by_name = {}
    for name, d in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + d)
    log(f"  {steps} MPC control step(s): wall {wall_us / 1e3:.2f} ms "
        f"(profiled), device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f} %), {len(events)} device launches "
        f"({len(events) / steps:.0f} per control step)")
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:10]:
        log(f"  {t / 1e3:8.2f} ms {n:7d} x {name[:90]}")
    return len(events) / steps


def phase_batch(K, device="cuda", n_episodes=BATCH, steps=BATCH_STEPS,
                gate_cases=GATE_CASES, n_iter=MPC_IPM_ITERS, measured=None):
    """The main path at B = ``n_episodes``: host cases 0..B-1 of the
    protocol advance together through sicnav_diffusion.make_policy(
    batch=True) and rollout.batch_rollout_stateful for ``steps`` batched
    control steps, then the float64 gate on control step CROSS_STEP. The
    keyword arguments exist for the CPU rehearsal
    (tests/test_torch_batch_mpc.py). Returns (ocp, model, settings,
    (final states, their carries), kde launches)."""
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion import kde as KDE
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.rollout import batch_rollout_stateful
    from sicnav_tpu_torch.mpc import ipm
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cuda = torch.device(device).type == "cuda"
    cfg = protocol_env()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    settings = ipm.IPMSettings(n_iter=n_iter)
    model = trained_model(device)
    ocp, init_carry_fn, step_fn = SD.make_policy(
        cfg, model, fcfg=fcfg, settings=settings, device=device, batch=True)
    cases = list(range(n_episodes))
    states = crowd_sim.reset_batch(cfg, cases, device=device)
    carries = init_carry_fn(cases)

    times = {"env": [], "forecast": [], "mpc": []}
    served, ranked, accepted, actions = [], [], [], []
    last, record, carried = [None], [], [carries]

    def timed_forecast(orig):
        def fn(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            _sync(device)
            times["forecast"].append(time.perf_counter() - t0)
            served.append(out)
            return out
        return fn

    def kept_kde(orig):
        def fn(preds, bandwidth):
            ranked.append((preds, bandwidth))
            return orig(preds, bandwidth)
        return fn

    def timed_step(states, carries):
        _sync(device)
        t0 = time.perf_counter()
        if last[0] is not None:
            times["env"].append(t0 - last[0])
        action, new_carries = step_fn(states, carries)
        _sync(device)
        t1 = time.perf_counter()
        times["mpc"].append(t1 - t0 - times["forecast"][-1])
        accepted.append(new_carries.mpc.prev_ok)
        actions.append(action)
        carried[0] = new_carries
        if len(actions) == min(CROSS_STEP, steps - 1) + 1:
            record[:] = [len(actions) - 1, states, carries.mpc, served[-1]]
        last[0] = t1
        return action, new_carries

    restore = [_wrap(FC, "predict_ret_best", timed_forecast),
               _wrap(KDE, "kde_loglik_fused", kept_kde)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.kde_loglik.launches = 0
    try:
        t0 = time.perf_counter()
        final, stats = batch_rollout_stateful(states, carries, timed_step,
                                              cfg, steps)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        for r in restore:
            r()
    launches = K.kde_loglik.launches
    peak = torch.cuda.max_memory_allocated() if cuda else None

    B, H, k, F = n_episodes, cfg.max_humans, fcfg.num_ret_samples, fcfg.horizon
    assert len(served) == steps == len(actions) == len(ranked)
    for fc, lw in served:
        assert tuple(fc.shape) == (B, H, k, F + 1, 2), tuple(fc.shape)
        for i in range(B):
            check_forecast(fc[i], lw[i], H, k, F)
    for a in actions:
        assert tuple(a.shape) == (B, 2) and bool(torch.isfinite(a).all()), a
    for preds, _ in ranked:
        assert tuple(preds.shape) == (8 * B, 48, 2 * H), tuple(preds.shape)
    if cuda:
        assert launches == steps, (launches, steps)
    assert bool(torch.isfinite(final.h_pos).all())
    acc = torch.stack(accepted).float()
    log(f"  {B} protocol episodes (host cases 0-{B - 1}), {steps} batched "
        f"control steps of 122, IPM {settings.n_iter} iterations: "
        f"success {stats.success.sum().item()}, collision episodes "
        f"{(stats.collision_steps > 0).sum().item()}, live episode-steps "
        f"{stats.steps.sum().item()}")
    for part, xs in times.items():
        log(f"  {part} per batched step: median "
            f"{statistics.median(xs) * 1e3:.2f} ms, p90 "
            f"{pct(xs, 0.9) * 1e3:.2f} ms over {len(xs)} steps")
    step_s = (statistics.median([f + m for f, m in zip(times["forecast"],
                                                       times["mpc"])]) +
              statistics.median(times["env"]))
    rate = B / step_s
    b1 = (measured or {}).get("b1_step_s")
    b1_text = (f"; B = 1 (mpc phase): {1 / b1:.4f} episode-steps/s, "
               f"{rate * b1:.2f}x" if b1 else "")
    log(f"  batched control step with its env step: median {step_s * 1e3:.2f}"
        f" ms; {rate:.4f} episode-steps/s at B = {B}{b1_text}; rollout wall "
        f"{wall:.2f} s")
    log(f"  cascade accepted the solution on {int(acc.sum().item())} of "
        f"{acc.numel()} episode-steps ({100 * acc.mean().item():.1f} %); "
        f"{launches} kde_loglik launches in {steps} batched steps, on "
        f"{tuple(ranked[0][0].shape)}")
    if peak is not None:
        log(f"  peak device memory (max_memory_allocated): "
            f"{peak / 2**20:.1f} MiB")
    if measured is not None:
        measured["batch_step_s"] = step_s
    if cuda:
        check_live_kde(K, ranked)
    phase_batch_gate(ocp, record, settings, gate_cases)
    return ocp, model, settings, (final, carried[0]), launches


def phase_batch_gate(ocp_batch, record, settings, n):
    """The batch phase's gate (``batch_gate``) on the fused controller's
    MPC half: the batched step is act_on_forecasts_batch, the unbatched
    one act_on_forecasts, both on the recorded served forecasts."""
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cfg = protocol_env()
    k, states, carries, served = record

    def batched(st, ca, extra, s):
        return SD.act_on_forecasts_batch(ocp_batch, st, ca, *extra, cfg, s,
                                         aux=True)

    def single(ocp, st, ca, extra, s):
        return SD.act_on_forecasts(ocp, st, ca, *extra, cfg, s, aux=True)

    batch_gate(ocp_batch, k, states, carries, served, settings, n, batched,
               single)


def batch_gate(ocp_batch, k, states, carries, extra, settings, n, batched,
               single):
    """Control step k of cases 0..n-1 in float64: ``batched(states,
    carries, extra, settings)`` once for the n episodes, ``single(ocp,
    state, carry, extra, settings)`` once per episode, from the same
    states, carries and per-episode inputs ``extra``, on the same device.
    Every cascade branch equal; each action within BATCH_ACTION_TOL,
    unless the unbatched step itself moves by more than that between this
    device and the CPU (rounding decides the step; see BATCH_ACTION_TOL's
    note): then within CROSS_ACTION_F32_TOL. At most one case may be
    decided by rounding. Then the same step at GATE_SHORT_ITERS IPM
    iterations: every action within BATCH_ACTION_TOL and every branch
    equal."""
    from sicnav_tpu_torch.env.crowd_sim import tree_map
    from sicnav_tpu_torch.mpc.ocp import OCP

    def f64(x):
        return x.double() if x.is_floating_point() else x

    st, ca, *ex = (tree_map(lambda x: f64(x[:n]), t)
                   for t in (states, carries, *extra))
    dev = st.r_pos.device
    t0 = time.perf_counter()
    a_b, _, aux_b = batched(st, ca, ex, settings)
    _sync(dev)
    ms_b = (time.perf_counter() - t0) * 1e3
    ocp_1 = OCP(ocp_batch.cfg, device=dev)
    branches = ("use_guess", "sol_feasible", "sol_realistic", "cost_worse",
                "braked", "rescued")

    def episode(i):
        return [tree_map(lambda x: x[i], t) for t in (st, ca)], \
            [tree_map(lambda x: x[i], t) for t in ex]

    errs, ms_1, decided_by_rounding = [], [], []
    for i in range(n):
        (st_i, ca_i), ex_i = episode(i)
        t0 = time.perf_counter()
        a_i, _, aux_i = single(ocp_1, st_i, ca_i, ex_i, settings)
        _sync(dev)
        ms_1.append((time.perf_counter() - t0) * 1e3)
        assert a_i.dtype == torch.float64 == a_b.dtype
        errs.append((a_b[i] - a_i).abs().max().item())
        for name in branches:
            got, want = getattr(aux_b, name)[i], getattr(aux_i, name)
            assert bool(got == want), (i, name, got, want)
        note = ""
        if errs[-1] > BATCH_ACTION_TOL:
            # the same unbatched step on the CPU: how far rounding alone
            # moves it
            def cpu(t):
                return tree_map(lambda x: x.cpu(), t)
            a_cpu = single(OCP(ocp_batch.cfg, device="cpu"), cpu(st_i),
                           cpu(ca_i), [cpu(t) for t in ex_i], settings)[0]
            e_cpu = (a_i.cpu() - a_cpu).abs().max().item()
            note = (f"; the unbatched step on the CPU {a_cpu.tolist()}, "
                    f"{e_cpu:.3e} from the card's")
            assert e_cpu > BATCH_ACTION_TOL, (i, errs[-1], e_cpu)
            assert errs[-1] <= CROSS_ACTION_F32_TOL, (i, errs[-1])
            decided_by_rounding.append(i)
        log(f"  gate case {i}, control step {k}: batched action "
            f"{a_b[i].tolist()}, unbatched {a_i.tolist()}, max abs err "
            f"{errs[-1]:.3e}; use_guess {bool(aux_i.use_guess)}, braked "
            f"{bool(aux_i.braked)} on both{note}")
    strict = [e for i, e in enumerate(errs) if i not in decided_by_rounding]
    log(f"  float64 gate: cascade branches equal; max abs err "
        f"{max(strict, default=0.0):.3e} on the {len(strict)} cases float64 "
        f"decides (bound {BATCH_ACTION_TOL}); cases decided by rounding "
        f"{decided_by_rounding} (bound {CROSS_ACTION_F32_TOL}); batched "
        f"step {ms_b:.1f} ms for {n} episodes, unbatched {sum(ms_1):.1f} ms")
    assert len(decided_by_rounding) <= 1, decided_by_rounding

    short = dataclasses.replace(settings, n_iter=GATE_SHORT_ITERS)
    a_b, _, aux_b = batched(st, ca, ex, short)
    errs = []
    for i in range(n):
        (st_i, ca_i), ex_i = episode(i)
        a_i, _, aux_i = single(ocp_1, st_i, ca_i, ex_i, short)
        errs.append((a_b[i] - a_i).abs().max().item())
        for name in branches:
            got, want = getattr(aux_b, name)[i], getattr(aux_i, name)
            assert bool(got == want), (i, name, got, want)
    log(f"  float64 gate at {GATE_SHORT_ITERS} IPM iterations: max abs err "
        f"{max(errs):.3e} over the {n} cases (bound {BATCH_ACTION_TOL}), "
        f"cascade branches equal")
    assert max(errs) <= BATCH_ACTION_TOL, errs


def phase_profile_batch(ocp, model, settings, final):
    """torch.profiler (device activity only) over one batched control step
    from the batch phase's last states and carries. Prints the launches,
    the device's busy share and the kernels that take the most device time;
    returns the launches."""
    from torch.profiler import ProfilerActivity, profile
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cfg = protocol_env()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10, dt=cfg.dt)
    states, carries = final
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        action, carries = SD.sicnav_diffusion_action_batch(
            ocp, model, states, carries, cfg, fcfg, settings)
        crowd_sim.step_masked(states, action, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
    busy_us = sum(d for _, d in events)
    assert busy_us > 0, "the profiler saw no device time"
    by_name = {}
    for name, d in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + d)
    B = action.shape[0]
    log(f"  1 batched control step (B = {B}): wall {wall_us / 1e3:.2f} ms "
        f"(profiled), device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / wall_us:.1f} %), {len(events)} device launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:10]:
        log(f"  {t / 1e3:8.2f} ms {n:7d} x {name[:90]}")
    kde = [(n, t) for name, (n, t) in by_name.items()
           if "kde_loglik_kernel" in name]
    for n, t in kde:
        log(f"  kde_loglik_kernel: {n} launch(es), {t / n:.2f} us each")
    return len(events)


def phase_harness(device="cuda", n_cases=BATCH, progress_file=None):
    """harness.evaluate_policy end to end: the batched DWA policy over host
    cases 0..n_cases-1 of the protocol at the full 122 steps, one batch,
    with a progress file; then the same call again, which must resume the
    batch from the file without stepping and return the same summary."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env import rollout
    from sicnav_tpu_torch.policies.dwa import dwa_policy_batch

    cfg = protocol_env()
    if progress_file is None:
        progress_file = os.path.join(ROOT, "build", "harness_progress.jsonl")
    os.makedirs(os.path.dirname(progress_file), exist_ok=True)
    if os.path.exists(progress_file):
        os.remove(progress_file)

    def policy(states):
        return dwa_policy_batch(states, cfg)

    def run():
        t0 = time.perf_counter()
        res = harness.evaluate_policy(policy, cfg, n_cases, batch=n_cases,
                                      progress_file=progress_file,
                                      device=device)
        _sync(device)
        return res, time.perf_counter() - t0

    first, wall = run()
    rollouts = []

    def counted(orig):
        def fn(*args, **kwargs):
            rollouts.append(1)
            return orig(*args, **kwargs)
        return fn

    restore = _wrap(rollout, "batch_rollout", counted)
    try:
        second, wall2 = run()
    finally:
        restore()
    assert first["num_cases"] == n_cases, first
    assert not rollouts, "the resumed call stepped the batch again"
    assert second == first, (first, second)
    log(f"  DWA over host cases 0-{n_cases - 1} (122 steps, batch "
        f"{n_cases}): {json.dumps(first)}")
    log(f"  evaluate_policy wall {wall:.2f} s; resumed from "
        f"{os.path.relpath(progress_file, ROOT)} in {wall2:.3f} s with the "
        f"same summary")
    return first


def train_env():
    """train_jmid's sim environment for the hallway predictor: the hallway
    bottleneck, 5 ORCA-plus humans in 5 slots starting at once, a holonomic
    robot driven by ORCA."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                     human_num=5, max_humans=5, starts_moving=0,
                     robot_kinematics="holonomic")


def _state_close(name, got, want, tol, relative):
    """max |got - want| (of the largest |want| when ``relative``) over a
    state_dict-like pair; raises above ``tol``."""
    worst, where = 0.0, ""
    for k, w in want.items():
        g = got[k].detach().cpu().double()
        w = w.detach().cpu().double()
        e = (g - w).abs().max().item()
        if relative:
            e /= max(w.abs().max().item(), 1e-30)
        if e > worst:
            worst, where = e, k
    assert worst <= tol, (name, where, worst)
    return worst, where


def phase_train_cross(model, batch, mcfg, tc, label="", end_to_end=True):
    """One train step on the card against the same step on the CPU: the
    trained weights, one stacked batch, t and eps drawn once, dropout 0.
    The attention key biases are held apart: a key bias adds one constant
    to each query's logits, which the softmax cancels, so its gradient is
    rounding alone on both sides and Adam steps it by up to lr on that
    sign; it does not enter the model's function.

    The card's Adam step is also held, on every element, to a CPU Adam step
    on the card's own clipped gradients from the same start. With
    ``end_to_end`` false that is the parameters' gate, and the card-vs-CPU
    parameter difference is printed, not held: a gradient element within
    the gradient bound of zero has rounding's sign and size on each side,
    and Adam's first step, lr g / (|g| + eps), turns that into up to lr
    either way."""
    from sicnav_tpu_torch.diffusion import mid as MID

    cfg0 = dataclasses.replace(mcfg, dropout=0.0, rnn_dropout=0.0)
    B, A = batch.agent_mask.shape
    gen = torch.Generator().manual_seed(SEED + 3)
    t = torch.randint(1, 101, (B, A), generator=gen)
    eps = torch.randn((B, A, mcfg.horizon, 2), generator=gen)

    def fresh(dev):
        m = MID.JMIDModel(cfg0, joint=model.denoiser_joint, device=dev)
        m.load_state_dict(model.state_dict())
        return m, MID.make_train_state(m, tc, 1, init=False)

    out = {}
    for dev in ("cuda", "cpu"):
        m, state = fresh(dev)
        loss = MID.train_step(m, state, batch.to_tensors(dev), t=t.to(dev),
                              eps=eps.to(dev))
        out[dev] = (loss.item(),
                    {k: p.grad for k, p in m.named_parameters()},
                    m.state_dict())
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
    key_bias = [k for k in g_cpu if k.endswith("attn.key.bias")]
    scale = max(g.abs().max().item() for g in g_cpu.values())
    kb = max(max(g_gpu[k].abs().max().item(), g_cpu[k].abs().max().item())
             for k in key_bias)
    rest = [k for k in g_cpu if k not in key_bias]
    g_err, g_at = _state_close("gradients", g_gpu,
                               {k: g_cpu[k] for k in rest}, TRAIN_GRAD_TOL,
                               True)
    m, state = fresh("cpu")
    for k, p in m.named_parameters():
        p.grad = g_gpu[k].detach().cpu().clone()
    state.optimizer.step()
    o_err, o_at = _state_close("Adam on the card's gradients", p_gpu,
                               m.state_dict(), TRAIN_PARAM_TOL, False)
    if end_to_end:
        p_err, p_at = _state_close("parameters", p_gpu,
                                   {k: p_cpu[k] for k in rest},
                                   TRAIN_PARAM_TOL, False)
        params = (f"parameters after Adam max err {p_err:.3e} ({p_at}; "
                  f"bound {TRAIN_PARAM_TOL})")
    else:
        diff = [(p_gpu[k].detach().cpu() - p_cpu[k]).abs() for k in rest]
        p_err = max(d.max().item() for d in diff)
        n_over = sum(int((d > TRAIN_PARAM_TOL).sum()) for d in diff)
        params = (f"parameters after Adam, card vs CPU (not held) max err "
                  f"{p_err:.3e}, {n_over} of "
                  f"{sum(d.numel() for d in diff)} elements above "
                  f"{TRAIN_PARAM_TOL}")
    l_err = abs(l_gpu - l_cpu)
    log(f"  one {label}train step, card vs CPU (batch of {B} scenes, "
        f"dropout 0): "
        f"loss {l_gpu:.7f} vs {l_cpu:.7f}, err {l_err:.3e} (bound "
        f"{TRAIN_LOSS_TOL}); gradients max err {g_err:.3e} of the tensor's "
        f"largest entry ({g_at}; bound {TRAIN_GRAD_TOL}); {params}; the "
        f"card's Adam step against a CPU Adam step on the card's gradients, "
        f"every element, max err {o_err:.3e} ({o_at}; bound "
        f"{TRAIN_PARAM_TOL}); key bias gradients up to {kb:.3e} "
        f"({kb / scale:.1e} of the largest gradient)")
    assert l_err <= TRAIN_LOSS_TOL, l_err
    assert kb <= TRAIN_GRAD_TOL * scale, (kb, scale)


def profile_train_step(model, batch, tc):
    """torch.profiler (device activity) over one train step of a copy of
    the model, after one warm-up step: launches, busy share, peak memory."""
    import copy
    from torch.profiler import ProfilerActivity, profile
    from sicnav_tpu_torch.diffusion import mid as MID

    m = copy.deepcopy(model)
    state = MID.make_train_state(m, tc, 1, init=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    MID.train_step(m, state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        MID.train_step(m, state, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    peak = torch.cuda.max_memory_allocated()
    events = device_events(prof)
    busy_us = sum(d for _, d in events)
    assert busy_us > 0, "the profiler saw no device time"
    by_name = {}
    for name, d in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + d)
    log(f"  1 train step (profiled): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{len(events)} device launches; peak device memory "
        f"(max_memory_allocated) {peak / 2**20:.1f} MiB")
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:8]:
        log(f"  {t / 1e3:8.2f} ms {n:7d} x {name[:90]}")


def _sweep(model, val, tc, device, noises):
    """eval_scene_full on each validation scene, one scene per call, from
    the given start noise; {metric: [value per scene]}."""
    from sicnav_tpu_torch.diffusion import mid as MID
    out = {}
    for ex, x_T in zip(val, noises):
        m = MID.eval_scene_full(model, ex.to_tensors(device),
                                tc.eval_samples, x_T=x_T.to(device),
                                stride=tc.eval_stride)
        for k, v in m.items():
            out.setdefault(k, []).append(float(v))
    return out


def phase_train(K, device="cuda", mcfg=None, n_scenes=TRAIN_SCENES,
                epochs=TRAIN_EPOCHS, out_dir=None):
    """train_jmid's sim path on the port: data, fit, the full validation
    sweep on the kernel, the checkpoint's round trip and one served
    forecast. ``device``, ``mcfg``, ``n_scenes``, ``epochs`` and
    ``out_dir`` exist for the CPU rehearsal in
    tests/test_torch_train_scripts.py; the CUDA-only checks (profile, card
    vs CPU, the kernel's launches and its plain version) run on the card.
    Returns the sweep's kernel launches."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_jmid_torch as TJ
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion import kde as KDE
    from sicnav_tpu_torch.diffusion import mid as MID
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.env import crowd_sim

    cuda = torch.device(device).type == "cuda"
    if mcfg is None:
        mcfg = ModelConfig(context_dim=128, tf_layer=2)   # jmid_hallway's
    if out_dir is None:
        out_dir = os.path.join(ROOT, "build", "train")
    os.makedirs(out_dir, exist_ok=True)
    tc = MID.TrainConfig(batch_size=8, lr=1e-4, epochs=epochs, seed=SEED)
    cfg = train_env()
    K.kde_loglik.launches = 0

    _sync(device)
    t0 = time.perf_counter()
    examples = TJ.generate_sim_scenes(n_scenes, cfg, SEED, device=device)
    data_s = time.perf_counter() - t0
    np.random.default_rng(SEED).shuffle(examples)
    n_val = max(len(examples) // 10, 1)
    val, train = examples[:n_val], examples[n_val:]
    train_b, val_b = TJ.batches(train, tc.batch_size), TJ.batches(
        val, tc.batch_size)
    log(f"  data: {n_scenes} device resets ({cfg.scenario}, {cfg.human_num} "
        f"humans), a 60-step ORCA-robot rollout and build_examples in "
        f"{data_s:.2f} s: {len(train)} train examples ({len(train_b)} "
        f"batches of {tc.batch_size}), {len(val)} validation examples "
        f"({len(val_b)} batches)")

    model = MID.JMIDModel(mcfg, device=device)
    step_s = []

    def timed(orig):
        def fn(*args, **kwargs):
            _sync(device)
            t1 = time.perf_counter()
            out = orig(*args, **kwargs)
            _sync(device)
            step_s.append(time.perf_counter() - t1)
            return out
        return fn

    ckpt = os.path.join(out_dir, "jmid_train.npz")
    restore = _wrap(MID, "train_step", timed)
    try:
        _, history = MID.fit(model, train_b, val_b, tc, checkpoint_path=ckpt)
    finally:
        restore()
    assert len(history) == epochs, history
    for h in history:
        assert math.isfinite(h["loss"]) and math.isfinite(h["val_ade"]), h
    log(f"  fit: {len(step_s)} train steps, median "
        f"{statistics.median(step_s) * 1e3:.2f} ms, p90 "
        f"{pct(step_s, 0.9) * 1e3:.2f} ms; per epoch: " + "; ".join(
            f"epoch {h['epoch']} {h['seconds'] * 1e3:.0f} ms, loss "
            f"{h['loss']:.5f}, val ADE {h['val_ade']:.5f}" for h in history))

    batch = train_b[0]
    if cuda:
        profile_train_step(model, batch.to_tensors(device), tc)
        phase_train_cross(model, batch, mcfg, tc)

    # the full sweep, one scene per call, the same noise on the card and
    # on the CPU
    gen = torch.Generator().manual_seed(tc.seed + 7)
    noises = [torch.randn((tc.eval_samples * ex.agent_mask.shape[0],
                           mcfg.horizon, 2), generator=gen) for ex in val]
    ranked, ranked_cpu = [], []

    def kept_kde(into):
        def wrapper(orig):
            def fn(preds, bandwidth):
                into.append((preds, bandwidth))
                return orig(preds, bandwidth)
            return fn
        return wrapper

    restore = _wrap(KDE, "kde_loglik_fused", kept_kde(ranked))
    try:
        _sync(device)
        t1 = time.perf_counter()
        sweep = _sweep(model, val, tc, device, noises)
        _sync(device)
        sweep_s = time.perf_counter() - t1
    finally:
        restore()
    launches = K.kde_loglik.launches
    shapes = sorted({tuple(p.shape) for p, _ in ranked})
    nonfinite = {k: sum(not math.isfinite(x) for x in v)
                 for k, v in sweep.items()}
    means = {k: statistics.fmean([x for x in v if math.isfinite(x)] or
                                 [math.nan]) for k, v in sweep.items()}
    log(f"  full sweep over {len(val)} validation scenes in {sweep_s:.2f} s "
        f"({launches} kde_loglik launches on {shapes}): " + ", ".join(
            f"{k} {v:.5f}" for k, v in means.items()))
    cpu_text = ""
    if cuda:
        model_cpu = MID.JMIDModel(mcfg, device="cpu")
        model_cpu.load_state_dict(model.state_dict())
        restore = _wrap(KDE, "kde_loglik_fused", kept_kde(ranked_cpu))
        try:
            sweep_cpu = _sweep(model_cpu, val, tc, "cpu", noises)
        finally:
            restore()
        nonfinite_cpu = {k: sum(not math.isfinite(x) for x in v)
                         for k, v in sweep_cpu.items()}
        bad_cpu = sum(int((~torch.isfinite(K.kde_loglik_fused(p, bw)).all(
            dim=-1)).sum()) for p, bw in ranked_cpu)
        diff = max(abs(a - b) for k in sweep for a, b in
                   zip(sweep[k], sweep_cpu[k])
                   if math.isfinite(a) and math.isfinite(b))
        cpu_text = (f"; on the CPU from the same noise: {nonfinite_cpu}, "
                    f"KDE groups with non-finite likelihoods {bad_cpu}, "
                    f"finite metrics within {diff:.3e} of the card's")
    log(f"  non-finite per metric on {'the card' if cuda else 'the CPU'}: "
        f"{nonfinite}{cpu_text}")
    if cuda:
        assert launches == len(val), (launches, len(val))
        assert shapes == [(8, tc.eval_samples, 2 * cfg.max_humans)], shapes
        bad = check_live_kde(K, ranked)
        stacked = D.stack_batches(val)
        np.savez(os.path.join(out_dir, "sweep.npz"),
                 noises=np.stack([x.numpy() for x in noises]),
                 **{f"scene_{k}": v for k, v in stacked._asdict().items()},
                 **{f"card_{k}": np.array(v) for k, v in sweep.items()},
                 **{f"cpu_{k}": np.array(v) for k, v in sweep_cpu.items()})
        log(f"  KDE groups with non-finite likelihoods in the sweep on the "
            f"card: {bad}; scenes, noise, weights and both sweeps written to "
            f"{os.path.relpath(out_dir, ROOT)}")

    # the checkpoint: saved, loaded into a fresh model, sampled bit-equal
    MID.save_checkpoint(ckpt, model.state_dict())
    fresh = MID.JMIDModel(mcfg, device=device)
    fresh.load_state_dict(MID.load_checkpoint(ckpt), strict=True)
    one = val[0].to_tensors(device)
    x_T = noises[0].to(device)
    a = model.sample(one, tc.eval_samples, x_T=x_T)
    b = fresh.sample(one, tc.eval_samples, x_T=x_T)
    assert torch.equal(a, b), (a - b).abs().max()
    # ... and served: one forecast of the protocol env
    pcfg = protocol_env()
    fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                               dt=pcfg.dt)
    state = crowd_sim.reset_host(pcfg, 0, device=device)
    fstate = FC.init_state(pcfg.max_humans, fcfg, device=device)
    for _ in range(3):
        fstate = FC.update_state_hists(fstate, state, fcfg)
    fc, lw = FC.predict_ret_best(
        fresh, fstate, state, fcfg,
        generator=torch.Generator(device=device).manual_seed(SEED))
    check_forecast(fc, lw, pcfg.max_humans, fcfg.num_ret_samples,
                   fcfg.horizon)
    log(f"  checkpoint {os.path.relpath(ckpt, ROOT)} "
        f"({os.path.getsize(ckpt)} bytes): a fresh model samples bit-equal; "
        f"served one protocol forecast {tuple(fc.shape)}, log-weights "
        f"normalized")
    return launches


# ---------------------------------------------------------------------------
# the rl phase: the SARL and RGL baselines, served and trained
# ---------------------------------------------------------------------------

def rl_env():
    """The reference's RL configuration (scripts/eval_suite.py and
    train_rl.py at their defaults): circle crossing, 3 ORCA humans in 3
    slots starting at once, 15 s (62 steps), a unicycle robot."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(scenario="circle_crossing", human_policy="orca",
                     human_num=3, max_humans=3, starts_moving=0,
                     time_limit=15.0, robot_kinematics="unicycle")


def _profiled(fn):
    """torch.profiler (device activity) over one call of ``fn``: returns
    (wall ms, device busy ms, launches, the result)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(d for _, d in events) / 1e3
    assert busy_ms > 0, "the profiler saw no device time"
    return wall_ms, busy_ms, len(events), out


def rl_greedy(name, device, record=None):
    """The greedy policy of ``name``'s value network with the shipped
    weights (weights/<name>_200k.npz) on rl_env(), and the network."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import make_network
    cfg = rl_env()
    net = make_network(name, device=device)
    net.load_state_dict(load_npz(RL_WEIGHTS[name]))
    net.eval()
    dqn = D.DQNConfig()
    actions = D.build_action_space(cfg, dqn, device)
    return D.greedy_policy(net, cfg, dqn, actions, record), net


def _top2_gap(q):
    top = q.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def rl_serve(name, device, n_cases):
    """Greedy ``name`` from weights/<name>_200k.npz over host cases
    0..n_cases-1 of rl_env() at the full 62 steps, one batch, through
    harness.evaluate_policy. Returns (summary, per-case EpisodeStats, the
    Q-values of every step (T, B, A) on the CPU, the greedy actions' and
    the control steps' seconds: a control step runs from one greedy
    action to the next, the env step and the episode statistics
    included)."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env import rollout

    cfg = rl_env()
    record, times, steps, last = [], [], [], []
    greedy, _ = rl_greedy(name, device, record)

    def policy(states):
        _sync(device)
        t0 = time.perf_counter()
        if last:
            steps.append(t0 - last[-1])
        last.append(t0)
        action = greedy(states)
        _sync(device)
        times.append(time.perf_counter() - t0)
        return action

    stats = []

    def kept(orig):
        def fn(*args, **kwargs):
            out = orig(*args, **kwargs)
            stats.append(out[1])
            return out
        return fn

    restore = _wrap(rollout, "batch_rollout", kept)
    try:
        res = harness.evaluate_policy(policy, cfg, n_cases, batch=n_cases,
                                      device=device)
    finally:
        restore()
    q = torch.stack(record).cpu()
    assert bool(torch.isfinite(q).all()), name
    return res, stats[0], q, (times, steps)


def rl_serve_gate(name, card, cpu):
    """The card's serve against the CPU's on the same cases: step 0's
    Q-values within RL_Q_TOL, each case's outcome equal unless a step
    whose top-two Q gap is at most RL_TIE (on either side) first split the
    two runs' actions. Returns the cases such a near tie decided."""
    (_, st_g, q_g, _), (_, st_c, q_c, _) = card, cpu
    err0 = (q_g[0] - q_c[0]).abs().max().item()
    assert err0 <= RL_Q_TOL, (name, err0)
    ties = []
    for b in range(q_g.shape[1]):
        outcome = [(bool(s.success[b]), bool(s.timeout[b]),
                    int(s.collision_steps[b]) > 0, float(s.nav_time[b]))
                   for s in (st_g, st_c)]
        if outcome[0] == outcome[1]:
            continue
        split = (q_g[:, b].argmax(-1) != q_c[:, b].argmax(-1)).nonzero()
        assert len(split), (name, b, outcome)
        t = int(split[0])
        gap = min(_top2_gap(q_g[t, b]).item(), _top2_gap(q_c[t, b]).item())
        assert gap <= RL_TIE, (name, b, t, gap, outcome)
        ties.append((b, t, gap))
    log(f"  [{name}] card vs CPU: step 0's Q within {err0:.3e} (bound "
        f"{RL_Q_TOL}); cases a near tie decided: "
        + (", ".join(f"case {b} (step {t}, top-two gap {g:.2e})"
                     for b, t, g in ties) or "none"))
    return ties


def rl_profile_serve(name, device, n_cases):
    """One batched greedy step with its env step, profiled."""
    from sicnav_tpu_torch.env import crowd_sim

    cfg = rl_env()
    greedy, _ = rl_greedy(name, device)
    states = crowd_sim.reset_batch(cfg, range(n_cases), device=device)

    def step():
        return crowd_sim.step_masked(states, greedy(states), cfg)

    step()
    wall, busy, launches, _ = _profiled(step)
    log(f"  [{name}] one batched control step (B = {n_cases}, profiled): "
        f"wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f} %), {launches} device launches")


def sync_count(fn):
    """Host syncs torch's sync debug mode reports while ``fn()`` runs: each
    read of the device warns "called a synchronizing CUDA operation" once
    (the mode's own notice that it is a prototype is not counted)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if str(w.message).startswith("called a synchronizing")]


def rl_train_cross(net, target, batch, dqn, devices=("cuda", "cpu")):
    """One train step on the card against the CPU from the same
    parameters, target and batch: loss and parameters after Adam within
    RL_TRAIN_TOL. SARL's last attention bias, whose gradient is rounding
    alone (the softmax cancels it), is held to 3 lr of its start.
    ``devices`` exists for the CPU rehearsal."""
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import make_network
    out = []
    for dev in devices:
        n, t = make_network("sarl", device=dev), make_network("sarl",
                                                               device=dev)
        n.load_state_dict(net.state_dict())
        t.load_state_dict(target.state_dict())
        opt = D.make_optimizer(n, dqn)
        b = D.Transition(*[x.to(dev) for x in batch])
        loss = D.train_step(n, t, opt, b, dqn.gamma)
        out.append((loss.item(), n.state_dict()))
    (l_g, p_g), (l_c, p_c) = out
    shift = "attention.layers.2.bias"
    moved = max((p[shift].cpu() - net.state_dict()[shift].cpu()).abs().max()
                .item() for p in (p_g, p_c))
    assert moved <= 3 * dqn.lr, moved
    p_err, p_at = _state_close("parameters", p_g,
                               {k: v for k, v in p_c.items() if k != shift},
                               RL_TRAIN_TOL, False)
    l_err = abs(l_g - l_c)
    log(f"  one DQN train step, card vs CPU (batch {batch.reward.shape[0]}):"
        f" loss {l_g:.7f} vs {l_c:.7f}, err {l_err:.3e} (bound "
        f"{RL_TRAIN_TOL}); parameters after Adam max err {p_err:.3e} "
        f"({p_at}; bound {RL_TRAIN_TOL}); the softmax-cancelled bias moved "
        f"{moved:.2e} (bound 3 lr = {3 * dqn.lr:.1e})")
    assert l_err <= RL_TRAIN_TOL, l_err


def rl_collect_cross(net, cfg, dqn, states, devices=("cuda", "cpu")):
    """One collect step on the card and on the CPU from the same states,
    parameters and handed-in draws: transitions within RL_TRAIN_TOL where
    the chosen actions agree, which they must wherever the top-two gap
    exceeds RL_TIE or the step explores. ``devices`` exists for the CPU
    rehearsal."""
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import make_network
    B = states.t.shape[0]
    A = 1 + dqn.speed_samples * dqn.rotation_samples
    draws = D.collect_draws(cfg, B, A, torch.Generator().manual_seed(SEED + 5),
                            "cpu")
    step = 1000                    # exploring at eps = 0.4
    out = []
    for dev in devices:
        n = make_network("sarl", device=dev)
        n.load_state_dict(net.state_dict())
        acts = D.build_action_space(cfg, dqn, dev)
        s = crowd_sim.tree_map(lambda x: x.to(dev), states)
        with torch.no_grad():
            q = D.make_q_fn(n, cfg, dqn, acts)(s)
        d = (draws[0].to(dev), draws[1].to(dev),
             tuple(x.to(dev) for x in draws[2]))
        collect = D.make_collect_step(n, cfg, dqn, acts)
        _, trans, _ = collect(s, step, draws=d)
        out.append((q.cpu(), crowd_sim.tree_map(lambda x: x.cpu(), trans)))
    (q_g, tr_g), (q_c, tr_c) = out
    explore = draws[0] < D.epsilon(step, dqn)
    chose_g = torch.where(explore, draws[1], q_g.argmax(-1))
    chose_c = torch.where(explore, draws[1], q_c.argmax(-1))
    decided = explore | (torch.minimum(_top2_gap(q_g), _top2_gap(q_c)) >
                         RL_TIE)
    assert torch.equal(chose_g[decided], chose_c[decided])
    same = chose_g == chose_c
    worst = max((g[same].double() - c[same].double()).abs().max().item()
                for g, c in zip(tr_g, tr_c) if g.dtype != torch.bool)
    for g, c in zip(tr_g, tr_c):
        if g.dtype == torch.bool:
            assert torch.equal(g[same], c[same])
    log(f"  one collect step, card vs CPU (B = {B}, the same draws): "
        f"{int(explore.sum())} explored, {int((~decided).sum())} greedy "
        f"choices within a near tie, {int((~same).sum())} actions apart; "
        f"transitions max err {worst:.3e} (bound {RL_TRAIN_TOL})")
    assert worst <= RL_TRAIN_TOL, worst


def rl_train(device, il_episodes, il_epochs, n_envs, collect_steps, dqn,
             out_dir):
    """train_rl_torch.py's path at the published widths: the imitation
    bootstrap, then D.train; then the CUDA-only measurements and gates."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_rl_torch as TR
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl import imitation as IL
    from sicnav_tpu_torch.rl.networks import make_network

    cuda = torch.device(device).type == "cuda"
    cfg = TR.env_config(TR.parse_args([]))
    assert cfg == rl_env(), cfg
    il = IL.ILConfig(il_episodes=il_episodes, il_epochs=il_epochs)
    net = make_network("sarl", device=device, seed=SEED)
    log_every = max(collect_steps // 4, 1)
    log(f"  cuts: IL_EPISODES {il_episodes} of 300, IL_EPOCHS {il_epochs} of "
        f"100, DQN {n_envs} x {collect_steps} = {n_envs * collect_steps} of "
        f"200,000 env steps; log_every {log_every} of 200")

    _sync(device)
    t0 = time.perf_counter()
    data = IL.collect_demonstrations(cfg, il, seed=SEED, device=device)
    _sync(device)
    demo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, losses = IL.fit_value_net(net, data, il, seed=SEED)
    fit_s = time.perf_counter() - t0
    assert all(math.isfinite(x) for x in losses), losses
    log(f"  demonstrations: {data[0].shape[0]} states of {il_episodes} "
        f"episodes in {demo_s:.2f} s; IL fit {il_epochs} epochs in "
        f"{fit_s:.2f} s, loss {losses[0]:.5f} -> {losses[-1]:.5f}")

    times = {"collect": [], "train": []}

    def timed(kind):
        def wrapper(orig):
            def fn(*args, **kwargs):
                _sync(device)
                t1 = time.perf_counter()
                out = orig(*args, **kwargs)
                _sync(device)
                times[kind].append(time.perf_counter() - t1)
                return out
            return fn
        return wrapper

    def timed_factory(orig):
        def make(*args, **kwargs):
            return timed("collect")(orig(*args, **kwargs))
        return make

    restores = [_wrap(D, "train_step", timed("train")),
                _wrap(D, "make_collect_step", timed_factory)]
    try:
        t0 = time.perf_counter()
        params, history = D.train(net, cfg, dqn, n_envs=n_envs, seed=SEED,
                                  total_steps=n_envs * collect_steps,
                                  log_every=log_every, device=device)
        _sync(device)
        dqn_s = time.perf_counter() - t0
    finally:
        for r in restores:
            r()
    assert history, "no history record: no train step was logged"
    for h in history:
        assert math.isfinite(h["loss"]), h
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    for kind, xs in times.items():
        log(f"  {kind} step: median {statistics.median(xs) * 1e3:.2f} ms, "
            f"p90 {pct(xs, 0.9) * 1e3:.2f} ms over {len(xs)} steps")
    log(f"  DQN {n_envs * collect_steps} env steps in {dqn_s:.2f} s: "
        f"{n_envs * collect_steps / dqn_s:.1f} env steps per second; last "
        f"record {json.dumps(history[-1])}")

    # one collect and one train step outside D.train, for the profile, the
    # sync count, the card-vs-CPU gates and the checkpoint
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    actions = D.build_action_space(cfg, dqn, device)
    states = crowd_sim.reset_device(cfg, n_envs, gen, device)
    collect = D.make_collect_step(net, cfg, dqn, actions, base=states)
    buf = D.ReplayBuffer.create(dqn.buffer_capacity, cfg.max_humans, device)
    target = make_network("sarl", device=device)
    target.load_state_dict(net.state_dict())
    opt = D.make_optimizer(net, dqn)
    step = 0
    while buf.size < dqn.batch_size:
        states, trans, _ = collect(states, step, gen)
        buf = D.buffer_add(buf, trans, n_envs)
        step += n_envs
    carry = {"states": states, "buf": buf}

    def collect_once(s):
        s, trans, _ = collect(s, step, gen)
        carry["buf"] = D.buffer_add(carry["buf"], trans, n_envs)
        return s

    def train_once(_):
        batch = D.buffer_sample(carry["buf"], dqn.batch_size, gen)
        return D.train_step(net, target, opt, batch, dqn.gamma)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        wall, busy, launches, _ = _profiled(
            lambda: train_once(collect_once(carry["states"])))
        peak = torch.cuda.max_memory_allocated()
        log(f"  one collect + train step (profiled, B = {n_envs}): wall "
            f"{wall:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f} %), {launches} device launches, peak "
            f"device memory (max_memory_allocated) {peak / 2**20:.1f} MiB")
        syncs = sync_count(
            lambda: train_once(collect_once(carry["states"])))
        log(f"  host syncs in one collect + train step (sync debug mode): "
            f"{len(syncs)} (the ORCA LP's one read): {syncs}")
        assert len(syncs) == 1, syncs
        batch = D.buffer_sample(carry["buf"], dqn.batch_size, gen)
        rl_train_cross(net, target, batch, dqn)
        rl_collect_cross(net, cfg, dqn, crowd_sim.tree_map(
            lambda x: x.cpu(), carry["states"]))

    # the training checkpoint: saved and loaded bit-equal
    path = os.path.join(out_dir, "dqn_ckpt")
    D.save_train_checkpoint(path, step, net.state_dict(), target.state_dict(),
                            opt.state_dict(), carry["buf"])
    st, p2, tp2, opt2, buf2 = D.load_train_checkpoint(path, device)
    assert st == step and (buf2.idx, buf2.size) == (carry["buf"].idx,
                                                     carry["buf"].size)
    for a, b in ((net.state_dict(), p2), (target.state_dict(), tp2)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for x, y in zip(carry["buf"].data, buf2.data):
        assert torch.equal(x, y)
    for k, v in opt.state_dict()["state"].items():
        for name, x in v.items():
            assert torch.equal(x.cpu(), opt2["state"][k][name].cpu()), name
    log(f"  training checkpoint {os.path.relpath(path, ROOT)} "
        f"({os.path.getsize(os.path.join(path, D.CHECKPOINT_FILE))} bytes, "
        f"buffer {carry['buf'].size} of {dqn.buffer_capacity}): loaded "
        f"bit-equal")
    return history


def rl_lookahead2(device, n_envs):
    """One make_q2_fn call on n_envs circle-crossing resets with SARL at
    the shipped weights: its ms and launches."""
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.rl import dqn as D
    cfg = rl_env()
    _, net = rl_greedy("sarl", device)
    dqn = D.DQNConfig()
    q2 = D.make_q2_fn(net, cfg, dqn, D.build_action_space(cfg, dqn, device))
    states = crowd_sim.reset_batch(cfg, range(n_envs), device=device)

    def call():
        with torch.no_grad():
            return q2(states)

    q = call()
    assert q.shape == (n_envs, 31) and bool(torch.isfinite(q).all())
    if torch.device(device).type == "cuda":
        ms = call_ms(call, n=5, warmup=1)
        wall, busy, launches, _ = _profiled(call)
        log(f"  make_q2_fn on {n_envs} environments ({n_envs} x 31 x 31 = "
            f"{n_envs * 961} two-step branches): {ms:.2f} ms "
            f"(median of 5, synchronized); profiled: wall {wall:.2f} ms, "
            f"device busy {busy:.2f} ms, {launches} device launches")


def rl_humans(device):
    """One env step with SFM humans in the hallway bottleneck and one with
    linear humans in circle crossing, on ``device`` against the CPU."""
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.types import EnvConfig
    worst = {}
    for policy, scenario in (("sfm", "hallway_bottleneck"),
                             ("linear", "circle_crossing")):
        cfg = EnvConfig(scenario=scenario, human_policy=policy, human_num=5,
                        max_humans=5, starts_moving=0,
                        robot_kinematics="unicycle")
        action = torch.tensor([[0.8, 0.1], [0.5, -0.2], [1.0, 0.0],
                               [0.2, 0.3]])
        out = {}
        for dev in (device, "cpu"):
            s = crowd_sim.reset_batch(cfg, range(4), device=dev)
            out[dev] = crowd_sim.tree_map(
                lambda x: x.cpu(), crowd_sim.step_masked(s, action.to(dev),
                                                         cfg)[0])
        err = 0.0
        for a, b in zip(out[device], out["cpu"]):
            if not torch.is_tensor(a):
                continue
            if a.is_floating_point():
                err = max(err, (a.double() - b.double()).abs().max().item())
            else:
                assert torch.equal(a, b), policy
        assert err <= RL_HUMANS_TOL, (policy, err)
        worst[policy] = err
    log(f"  one env step of 4 episodes, {device} vs CPU: SFM humans in the "
        f"hallway bottleneck {worst['sfm']:.3e}, linear humans in circle "
        f"crossing {worst['linear']:.3e} (bound {RL_HUMANS_TOL})")


def phase_rl(device="cuda", n_cases=RL_CASES, il_episodes=IL_EPISODES,
             il_epochs=IL_EPOCHS, n_envs=DQN_ENVS,
             collect_steps=DQN_COLLECT_STEPS, dqn=None,
             lookahead2_envs=LOOKAHEAD2_ENVS, out_dir=None):
    """The SARL and RGL baselines: serve, train, lookahead2, humans. The
    keyword arguments exist for the CPU rehearsal
    (tests/test_torch_rl_eval.py); the CUDA-only checks (the CPU gates,
    profiles, the sync count) run on the card."""
    from sicnav_tpu_torch.rl import dqn as D
    cuda = torch.device(device).type == "cuda"
    if dqn is None:
        dqn = D.DQNConfig()
    if out_dir is None:
        out_dir = os.path.join(ROOT, "build", "rl")
    os.makedirs(out_dir, exist_ok=True)
    for name in ("sarl", "rgl"):
        t0 = time.perf_counter()
        served = rl_serve(name, device, n_cases)
        res, _, q, (times, steps) = served
        log(f"  [{name}] greedy over host cases 0-{n_cases - 1} (62 steps, "
            f"batch {n_cases}) in {time.perf_counter() - t0:.2f} s: success "
            f"{res['success_rate']}, collision {res['collision_episode_rate']},"
            f" timeout {res['timeout_rate']}, mean nav time "
            f"{res['mean_nav_time']} s; batched control step median "
            f"{statistics.median(steps) * 1e3:.2f} ms, p90 "
            f"{pct(steps, 0.9) * 1e3:.2f} ms, of which the greedy action "
            f"{statistics.median(times) * 1e3:.2f} ms, p90 "
            f"{pct(times, 0.9) * 1e3:.2f} ms, over {len(times)} steps")
        if cuda:
            rl_profile_serve(name, device, n_cases)
            rl_serve_gate(name, served, rl_serve(name, "cpu", n_cases))
    history = rl_train(device, il_episodes, il_epochs, n_envs, collect_steps,
                       dqn, out_dir)
    rl_lookahead2(device, lookahead2_envs)
    rl_humans(device)
    return history


# ---------------------------------------------------------------------------
# the imid phase: the ETH iMID predictor served and its recipe trained
# ---------------------------------------------------------------------------

def imid_data(device, n_rollouts, out_dir):
    """ETH-format files from the port's synthesizer on ``device``:
    {"train": [paths], "val": [paths]}."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import synthesize_ethucy_torch as SYN
    args = SYN.parser().parse_args(
        ["--out", os.path.join(out_dir, "eth"), "--n_scenes",
         str(n_rollouts), "--rollouts_per_file", str(IMID_ROLLOUTS_PER_FILE),
         "--seed", str(SEED)])
    return SYN.synthesize(args, device)


def _json_out(fn, argv):
    """Run a script's main(argv), returning its standard output's JSON
    lines (its own prints) as objects."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0, argv
    return [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith(("{", "["))]


def _lik_and_pick(pred, amask, joint):
    """Ranking scores (float32, the path's own function), each group's
    pick (the last of the largest, as the stable sort serves it) and each
    group's scale, the sum over the horizon of its largest |log
    likelihood|: joint (1, S), (1,), (1,); per agent (A, S), (A,), (A,)."""
    from sicnav_tpu_torch.ops.geometry import linspace
    from sicnav_tpu_torch.ops import kde_cuda as K
    fc = torch.where(amask[None, :, None, None], pred, torch.zeros_like(pred))
    S, A, T, _ = fc.shape
    if joint:
        bw = torch.exp(linspace(math.log(0.01), math.log(0.1), T,
                                device=fc.device))
        ll = K.kde_loglik_fused(fc.permute(2, 0, 1, 3).reshape(T, S, 2 * A),
                                bw)
        lik = (ll - torch.logsumexp(ll, 1, keepdim=True)).sum(0)[None]
        scale = ll.abs().amax(1).sum()[None]
    else:
        ll = K.kde_loglik_fused(fc.permute(1, 2, 0, 3).reshape(A * T, S, 2),
                                0.05)
        lik = (ll - torch.logsumexp(ll, 1, keepdim=True)).reshape(
            A, T, S).sum(1)
        scale = ll.abs().amax(1).reshape(A, T).sum(1)
    return lik, torch.argsort(lik, dim=-1, stable=True)[:, -1], scale


def imid_cross(model, ex, n_samples, seed):
    """One scene on the card against the CPU: the encoder's context, the
    samples from the same start noise, each ranking's scores on the card
    against the CPU's float64 scores of the CPU's samples, and each
    ranking's pick wherever the float64 top two stand more than IMID_TIE
    apart (near ties are counted and printed)."""
    from sicnav_tpu_torch.diffusion import mid as MID
    cpu = MID.JMIDModel(model.cfg, joint=False, device="cpu")
    cpu.load_state_dict(model.state_dict())
    A, T = ex.agent_mask.shape[0], model.cfg.horizon
    x_T = torch.randn((n_samples * A, T, 2),
                      generator=torch.Generator().manual_seed(seed))
    out = {}
    for dev, m in (("cuda", model), ("cpu", cpu)):
        b = ex.to_tensors(dev)
        out[dev] = (m.encode(b).cpu(), m.sample(b, n_samples,
                                                x_T=x_T.to(dev)).cpu())
    ctx_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    smp_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    assert ctx_err <= IMID_CTX_TOL, ctx_err
    assert smp_err <= IMID_SAMPLE_TOL, smp_err
    amask = torch.as_tensor(ex.agent_mask & ex.fut_mask.any(-1))
    text = []
    for joint in (True, False):
        lik_gpu, pick_gpu, _ = _lik_and_pick(out["cuda"][1].cuda(),
                                             amask.cuda(), joint)
        _, pick_cpu, _ = _lik_and_pick(out["cpu"][1], amask, joint)
        lik64, _, scale = _lik_and_pick(out["cpu"][1].double(), amask, joint)
        top = torch.sort(lik64, dim=-1).values[:, -2:]
        gap = top[:, 1] - top[:, 0]
        groups = torch.ones_like(gap, dtype=torch.bool) if joint else amask
        lik_err = ((lik_gpu.cpu().double() - lik64).abs().amax(-1) /
                   scale)[groups].max().item()
        assert lik_err <= IMID_LIK_TOL, (joint, lik_err)
        decided = (gap > IMID_TIE) & groups
        same = pick_gpu.cpu() == pick_cpu
        assert bool(same[decided].all()), (joint, gap, pick_gpu, pick_cpu)
        text.append(f"{'joint' if joint else 'per-agent'} ranking: scores "
                    f"max err {lik_err:.3e} of their terms' scale (largest "
                    f"{scale[groups].max().item():.4g}; bound "
                    f"{IMID_LIK_TOL}); "
                    f"{int(decided.sum())} of {int(groups.sum())} picks "
                    f"decided (top-two gap > {IMID_TIE}) and equal, "
                    f"{int((groups & ~decided).sum())} near ties (largest "
                    f"gap {gap[groups].max().item():.3e}; picks equal on "
                    f"{int(same[groups].sum())})")
    log(f"  one scene ({int(ex.agent_mask.sum())} agents, {n_samples} "
        f"samples), card vs CPU: context max err {ctx_err:.3e} (bound "
        f"{IMID_CTX_TOL}), samples from the same start noise {smp_err:.3e} "
        f"(bound {IMID_SAMPLE_TOL}); " + "; ".join(text))


def imid_ddpm_cross(model, ex):
    """DDPM on the cosine schedule, flexibility 0.5, from zeros
    (bestof=False), with the per-step noise drawn once on the CPU: the
    iMID denoiser's samples on the card against the CPU."""
    from sicnav_tpu_torch.diffusion import diffusion as DF
    from sicnav_tpu_torch.diffusion import mid as MID
    cpu = MID.JMIDModel(model.cfg, joint=False, device="cpu")
    cpu.load_state_dict(model.state_dict())
    n, stride = 4, 2
    A, T = ex.agent_mask.shape[0], model.cfg.horizon
    steps = DF.nfe_count(100, stride)
    noise = torch.randn((steps, n * A, T, 2),
                        generator=torch.Generator().manual_seed(SEED + 5))
    out = {}
    for dev, m in (("cuda", model), ("cpu", cpu)):
        sched = DF.make_schedule(100, "cosine", device=dev)
        with torch.no_grad():
            ctx = m.encode(ex.to_tensors(dev))
            out[dev] = DF.sample(m.denoiser, sched, n, ctx, T,
                                 sampling="ddpm", stride=stride,
                                 flexibility=0.5, bestof=False,
                                 noise=noise.to(dev)).cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    scale = out["cpu"].abs().max().item()
    assert bool(torch.isfinite(out["cuda"]).all())
    assert err <= IMID_SAMPLE_TOL * max(1.0, scale), (err, scale)
    log(f"  DDPM, cosine schedule, flexibility 0.5, bestof=False, {steps} "
        f"steps with injected noise: card vs CPU max err {err:.3e} (bound "
        f"{IMID_SAMPLE_TOL} x max(1, |x|max = {scale:.3f}))")


def imid_class_cross(device):
    """A class-conditioned JMID train step (num_node_types=3, the
    maneuver sim's typed scenes, jmid_mc's widths) on the card against the
    CPU."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_jmid_torch as TJ
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion import mid as MID
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    ex = TJ.generate_sim_scenes(4, TJ.sim_env_config("circle_crossing"),
                                SEED, multi_class=True,
                                class_mode="maneuver", device=device)
    batch = D.stack_batches(ex[:8])
    types = {D.NODE_TYPES[t]: int((batch.node_type == t).sum())
             for t in range(3)}
    mcfg = ModelConfig(context_dim=128, tf_layer=2, num_node_types=3)
    model = make_model(mcfg, device)
    tc = MID.TrainConfig(batch_size=8, seed=SEED)
    log(f"  maneuver sim: {len(ex)} typed examples, the batch's agents by "
        f"type {types}")
    phase_train_cross(model, batch, mcfg, tc, label="class-conditioned ")


def imid_cvae_cross(ex):
    """CVAETrajectron (Flax's initializers from SEED): its training loss
    and a prediction with sampled latents and GMM2D draws handed in, on
    the card against the CPU."""
    from sicnav_tpu_torch.diffusion import trajectron as TJ
    from sicnav_tpu_torch.diffusion.models import ModelConfig, init_parameters
    cfg = ModelConfig(context_dim=128, tf_layer=2)
    out = {}
    S, A, T = 6, ex.agent_mask.shape[0], cfg.horizon
    gen = torch.Generator().manual_seed(SEED + 6)
    z_draws = torch.randint(0, 25, (S, A, 1), generator=gen)
    y_noise = torch.randn((S, A, T, 1, 2), generator=gen)
    y_comp = torch.zeros((S, A, T), dtype=torch.long)
    for dev in ("cuda", "cpu"):
        net = TJ.CVAETrajectron(cfg, device="cpu")
        init_parameters(net, torch.Generator().manual_seed(SEED))
        net.to(dev)
        b = ex.to_tensors(dev)
        with torch.no_grad():
            loss = net.train_loss(b).item()
            pos, _ = net.predict(b, S, "sample", False, z_draws=z_draws.to(
                dev), y_noise=y_noise.to(dev), y_comp=y_comp.to(dev))
        out[dev] = (loss, pos.cpu())
    l_err = abs(out["cuda"][0] - out["cpu"][0])
    p_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    assert l_err <= TRAIN_LOSS_TOL * max(1.0, abs(out["cpu"][0])), l_err
    assert p_err <= IMID_SAMPLE_TOL, p_err
    log(f"  CVAETrajectron (encoder 128, K = 25): train_loss "
        f"{out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, err {l_err:.3e} "
        f"(bound {TRAIN_LOSS_TOL} x max(1, |loss|)); predict ({S} sampled "
        f"latents, GMM2D draws handed in) positions max err {p_err:.3e} "
        f"(bound {IMID_SAMPLE_TOL})")


def phase_imid(K, device="cuda", weights=None, widths=None,
               n_rollouts=IMID_ROLLOUTS, max_serve=IMID_SERVE_SCENES,
               recipe_model=None, out_dir=None):
    """The ETH iMID predictor: ETH-format data from the port's
    synthesizer, imid_eth_proof served through eval_prediction_torch.py
    --method mid --full with its KDE rankings on the kernel, card vs CPU,
    the ETH iMID recipe's train steps, and the rest of the MID family card
    vs CPU. ``weights``, ``widths``, ``n_rollouts``, ``max_serve``,
    ``recipe_model`` and ``out_dir`` exist for the CPU rehearsal
    (tests/test_torch_imid_phase.py); the CUDA-only checks run on the card.
    Returns the kernel's launches on the served path."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import eval_prediction_torch as EP
    import train_jmid_torch as TJ
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion import kde as KDE
    from sicnav_tpu_torch.diffusion import mid as MID
    from sicnav_tpu_torch.diffusion import recipes as R
    from sicnav_tpu_torch.diffusion.models import ModelConfig

    cuda = torch.device(device).type == "cuda"
    weights = weights or IMID_WEIGHTS
    widths = widths or IMID_WIDTHS
    if out_dir is None:
        out_dir = os.path.join(ROOT, "build", "imid")
    os.makedirs(out_dir, exist_ok=True)

    # data
    _sync(device)
    t0 = time.perf_counter()
    files = imid_data(device, n_rollouts, out_dir)
    val = TJ.load_files(files["val"])                # history 6, horizon 8
    recipe = R.get_recipe(IMID_RECIPE)
    train = TJ.load_files(files["train"], recipe.dt, recipe.history_len,
                          recipe.horizon)
    log(f"  data: {n_rollouts} rollouts synthesized on {device} in "
        f"{time.perf_counter() - t0:.2f} s ({len(files['train'])} train and "
        f"{len(files['val'])} val files): {len(val)} val examples at "
        f"history 6 / horizon 8 (eval_prediction's slicing), {len(train)} "
        f"train examples at the recipe's {recipe.history_len} / "
        f"{recipe.horizon}")
    val_path = os.path.join(out_dir, "eth", "serve.txt")
    # the served scenes: the first val file, cut to max_serve windows
    with open(files["val"][0]) as f:
        rows = f.read().splitlines()
    frames = sorted({int(r.split()[0]) for r in rows})
    keep = set(frames[:max_serve + 13])
    with open(val_path, "w") as f:
        f.write("\n".join(r for r in rows if int(r.split()[0]) in keep) +
                "\n")

    # serve
    model = MID.JMIDModel(ModelConfig(**widths), joint=False, device=device)
    model.load_state_dict(load_npz(weights), strict=True)
    ranked = []

    def kept(orig):
        def fn(preds, bandwidth):
            ranked.append((preds, bandwidth))
            return orig(preds, bandwidth)
        return fn

    argv = ["--method", "mid", "--weights", weights, "--encoder_dim",
            str(widths["context_dim"]), "--tf_layer",
            str(widths["tf_layer"]), "--data_files", val_path, "--full",
            "--num_samples", str(IMID_SAMPLES), "--seed", str(SEED)]
    if not cuda:
        argv += ["--device", "cpu"]
    K.kde_loglik.launches = 0
    restore = _wrap(KDE, "kde_loglik_fused", kept)
    try:
        _sync(device)
        t0 = time.perf_counter()
        (scores,) = _json_out(EP.main, argv)
        _sync(device)
        serve_s = time.perf_counter() - t0
    finally:
        restore()
    launches = K.kde_loglik.launches
    shapes = sorted({tuple(p.shape) for p, _ in ranked})
    n = scores["num_scenes"]
    bad = {k: v for k, v in scores.items() if k.endswith("_non_finite")}
    log(f"  served {os.path.basename(weights)} on {n} scenes "
        f"({IMID_SAMPLES} samples) in {serve_s:.2f} s: min-of-20 ADE "
        f"{scores['ade']:.5f} FDE {scores['fde']:.5f}; most likely (joint "
        f"ranking, the reference's sweep) ADE {scores['ml_ade']:.5f} FDE "
        f"{scores['ml_fde']:.5f}; most likely per agent ADE "
        f"{scores['ml_ade_per_agent']:.5f} FDE "
        f"{scores['ml_fde_per_agent']:.5f}; KDE-NLL "
        f"{scores['kde_nll']:.5f}; SADE {scores['sade']:.5f} SFDE "
        f"{scores['sfde']:.5f}; non-finite scene metrics {bad or 0}; "
        f"{launches} kde_loglik launches on {shapes}")
    for k in ("ade", "fde", "sade", "sfde", "ml_ade", "ml_fde",
              "ml_ade_per_agent", "ml_fde_per_agent"):
        assert math.isfinite(scores[k]), (k, scores[k])
    assert n > 0
    ex = [e for e in TJ.load_files([val_path])
          if (e.agent_mask & e.fut_mask.all(-1)).any()]
    assert len(ex) == n, (len(ex), n)
    # one scene's sampling latency, as --time measures it
    b0 = ex[0].to_tensors(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.sample(b0, IMID_SAMPLES, generator=gen)
    lat = []
    for _ in range(20):
        _sync(device)
        t1 = time.perf_counter()
        model.sample(b0, IMID_SAMPLES, generator=gen)
        _sync(device)
        lat.append(time.perf_counter() - t1)
    log(f"  one scene's {IMID_SAMPLES}-sample inference (50 DDIM steps): "
        f"median {statistics.median(lat) * 1e3:.2f} ms, p90 "
        f"{pct(lat, 0.9) * 1e3:.2f} ms over 20 calls")
    if cuda:
        A = ex[0].agent_mask.shape[0]
        assert launches == 2 * n, (launches, n)
        assert shapes == sorted([(A * 8, IMID_SAMPLES, 2),
                                 (8, IMID_SAMPLES, 2 * A)]), shapes
        check_live_kde(K, ranked)
        imid_cross(model, ex[0], IMID_SAMPLES, SEED + 1)
        imid_ddpm_cross(model, ex[0])

    # the recipe's train steps at its widths and batch size
    name = IMID_RECIPE
    if recipe_model is not None:
        R.RECIPES[name] = dataclasses.replace(recipe, model=recipe_model)
    ckpt = os.path.join(out_dir, "imid_recipe.npz")
    step_s, trained = [], []

    def timed(orig):
        def fn(m, state, batch, *args, **kwargs):
            _sync(device)
            t1 = time.perf_counter()
            out = orig(m, state, batch, *args, **kwargs)
            _sync(device)
            step_s.append(time.perf_counter() - t1)
            trained.append((m, state, batch))
            return out
        return fn

    argv = ["--recipe", name, "--epochs", "1", "--data_files",
            *files["train"], "--val_data_files", *files["val"],
            "--out", ckpt, "--seed", str(SEED)]
    if not cuda:
        argv += ["--device", "cpu"]
    restore = _wrap(MID, "train_step", timed)
    try:
        t0 = time.perf_counter()
        summary, history = _json_out(TJ.main, argv)[:2]
        fit_s = time.perf_counter() - t0
    finally:
        restore()
        R.RECIPES[name] = recipe
    m, state, batch = trained[-1]
    B, A = batch.agent_mask.shape
    log(f"  recipe {name} (encoder {m.cfg.context_dim}, {m.cfg.tf_layer} "
        f"layers, lr {recipe.train.lr}, batch {B} scenes of {A} agent "
        f"slots, horizon {m.cfg.horizon}): {len(step_s)} train steps in "
        f"{fit_s:.2f} s, step median {statistics.median(step_s) * 1e3:.2f} "
        f"ms, p90 {pct(step_s, 0.9) * 1e3:.2f} ms; summary {summary}")
    assert step_s and all(math.isfinite(h["loss"]) for h in history), history
    if cuda:
        profile_train_step(m, batch, state_tc(recipe, B))
        syncs = sync_count(lambda: MID.train_step(
            m, state, batch, torch.Generator(device="cuda").manual_seed(SEED)))
        log(f"  host syncs in one recipe train step (sync debug mode): "
            f"{len(syncs)} {sorted(set(syncs))}")
        assert not syncs, syncs
        numpy_batch = D.SceneBatch(*[None if x is None else x.cpu().numpy()
                                     for x in batch])
        # at this lr and batch, rounding-signed gradient elements move up
        # to lr either way on the two sides (phase_train_cross)
        phase_train_cross(m, numpy_batch, m.cfg, state_tc(recipe, B),
                          label="iMID recipe ", end_to_end=False)
        imid_class_cross(device)
        imid_cvae_cross(ex[0])
    return launches


def _observe_args(policy, device, n_iter, *extra):
    """scripts/eval_suite_torch.py's arguments of the observe phase."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import eval_suite_torch as ES
    return ES, ES.parse_args(["--policy", policy, "--noise_std",
                              str(OBSERVE_NOISE), "--kalman_filter",
                              "--ipm_iters", str(n_iter), "--device",
                              str(device), *extra])


def _timed_rollout(device, cases, init_carry_fn, step_fn, steps, times):
    """batch_rollout_stateful of the protocol's cases, each batched
    control step's seconds appended to ``times``; returns (final states,
    stats, the carries after each step)."""
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.env.rollout import batch_rollout_stateful

    cfg = protocol_env()
    states = crowd_sim.reset_batch(cfg, cases, device=device)
    carried = []

    def timed(states, carries):
        _sync(device)
        t0 = time.perf_counter()
        out = step_fn(states, carries)
        _sync(device)
        times.append(time.perf_counter() - t0)
        carried.append(out[1])
        return out

    final, stats = batch_rollout_stateful(states, init_carry_fn(cases),
                                          timed, cfg, steps)
    return final, stats, carried


def observe_plain(device, n_episodes, steps, n_iter, gate_cases):
    """Plain SICNav-p (eval_suite_torch.py --policy campc --privileged) under
    sigma = OBSERVE_NOISE noise and the Kalman filter, cases 0..B-1 as one
    batch; the float64 gate on step min(CROSS_STEP, steps - 1) of the
    filtered states; one profiled batched step on the card. Returns the
    recorded (ocp, filtered state, carry) of case 0 at that step."""
    from sicnav_tpu_torch.env.crowd_sim import tree_map
    from sicnav_tpu_torch.mpc import campc as C
    from sicnav_tpu_torch.mpc import ipm

    cfg = protocol_env()
    ES, args = _observe_args("campc", device, n_iter, "--privileged")
    k_gate = min(CROSS_STEP, steps - 1)
    record, built = [], []

    def recording(orig):
        def make(*a, **kw):
            ocp, init_fn, step_fn = orig(*a, **kw)
            built.append(ocp)

            def step(states, carries):
                if len(record) == k_gate:
                    record.append((states, carries))
                elif len(record) < k_gate:
                    record.append(None)
                return step_fn(states, carries)
            return ocp, init_fn, step
        return make

    restore = _wrap(C, "make_policy", recording)
    try:
        init_fn, step_fn = ES.campc_policy(args, cfg, torch.device(device))
    finally:
        restore()
    ocp = built[0]
    assert ocp.vmapped and ocp.cfg.priviledged_info and not ocp.cfg.door_yield
    times = []
    final, stats, carried = _timed_rollout(device, list(range(n_episodes)),
                                           init_fn, step_fn, steps, times)
    acc = torch.stack([c[1].prev_ok for c in carried]).float()
    assert bool(torch.isfinite(final.r_pos).all())
    assert all(bool(c[0].initialized.all()) for c in carried)
    settings = ipm.IPMSettings(n_iter=n_iter)
    log(f"  plain SICNav-p (campc --privileged, RA-L, wall margin "
        f"{ocp.cfg.wall_margin}), noise {OBSERVE_NOISE} + Kalman filter, "
        f"{n_episodes} episodes, {steps} batched steps of 122, IPM "
        f"{n_iter} iterations: MPC per batched step median "
        f"{statistics.median(times) * 1e3:.2f} ms, p90 "
        f"{pct(times, 0.9) * 1e3:.2f} ms; cascade accepted the solution on "
        f"{int(acc.sum().item())} of {acc.numel()} episode-steps "
        f"({100 * acc.mean().item():.1f} %); collision episodes "
        f"{(stats.collision_steps > 0).sum().item()}")
    states_k, carries_k = record[k_gate]

    def batched(st, ca, extra, s):
        with ipm.batched_lu_threads(ocp.device):
            return torch.func.vmap(lambda x, c: C.campc_action(
                ocp, x, c, cfg, s, aux=True))(st, ca)

    def single(o, st, ca, extra, s):
        return C.campc_action(o, st, ca, cfg, s, aux=True)

    batch_gate(ocp, k_gate, states_k, carries_k, (), settings, gate_cases,
               batched, single)
    if torch.device(device).type == "cuda":
        from sicnav_tpu_torch.env import crowd_sim
        wall, busy, n, _ = _profiled(lambda: crowd_sim.step_masked(
            final, step_fn(final, carried[-1])[0], cfg))
        log(f"  1 profiled batched plain step (B = {n_episodes}, with its "
            f"env step): wall {wall:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f} %), {n} device launches")
    return ocp, tree_map(lambda x: x[0], states_k), \
        tree_map(lambda x: x[0], carries_k)


def observe_fused(K, device, n_episodes, steps, n_iter):
    """The fused controller (eval_suite_torch.py --policy sicnav_diffusion)
    under the same noise and filter; returns the kernel's launches."""
    from sicnav_tpu_torch.diffusion import kde as KDE

    cfg = protocol_env()
    ES, args = _observe_args("sicnav_diffusion", device, n_iter)
    init_fn, step_fn = ES.sicnav_diffusion_policy(args, cfg,
                                                  torch.device(device))
    ranked, times = [], []

    def kept(orig):
        def fn(preds, bandwidth):
            ranked.append((preds, bandwidth))
            return orig(preds, bandwidth)
        return fn

    restore = _wrap(KDE, "kde_loglik_fused", kept)
    K.kde_loglik.launches = 0
    try:
        final, stats, carried = _timed_rollout(
            device, list(range(n_episodes)), init_fn, step_fn, steps, times)
    finally:
        restore()
    launches = K.kde_loglik.launches
    acc = torch.stack([c[1].mpc.prev_ok for c in carried]).float()
    assert bool(torch.isfinite(final.r_pos).all())
    assert len(ranked) == steps
    for preds, _ in ranked:
        assert tuple(preds.shape) == (8 * n_episodes, 48, 6), preds.shape
    if torch.device(device).type == "cuda":
        assert launches == steps, (launches, steps)
        check_live_kde(K, ranked)
    log(f"  fused SICNav-Diffusion, noise {OBSERVE_NOISE} + Kalman filter, "
        f"{n_episodes} episodes, {steps} batched steps, IPM {n_iter} "
        f"iterations: control step median {statistics.median(times) * 1e3:.2f}"
        f" ms, p90 {pct(times, 0.9) * 1e3:.2f} ms; cascade accepted "
        f"{int(acc.sum().item())} of {acc.numel()} episode-steps; "
        f"{launches} kde_loglik launches on {tuple(ranked[0][0].shape)}")
    return launches


def observe_debug(ocp_b, state, carry, n_iter):
    """debug_solve_report of the plain step's NLP (case 0, the gate's
    step) on the device and on the CPU, from the same guess: the trace's
    first iteration within OBSERVE_DEBUG_TOL, the worst class equal."""
    from sicnav_tpu_torch.env.crowd_sim import tree_map
    from sicnav_tpu_torch.mpc import campc as C
    from sicnav_tpu_torch.mpc import introspection as IN
    from sicnav_tpu_torch.mpc import ipm
    from sicnav_tpu_torch.mpc.ocp import OCP

    cfg = protocol_env()
    settings = ipm.IPMSettings(n_iter=n_iter)
    dev = state.r_pos.device
    out = {}
    for name, d in (("device", dev), ("cpu", torch.device("cpu"))):
        o = OCP(ocp_b.cfg, device=d)
        st, ca = (tree_map(lambda x: x.to(d), t) for t in (state, carry))
        params = C.step_problem(o, st, ca, cfg)[0]
        z0 = C._select_guess(o, ca, params)
        _sync(d)
        t0 = time.perf_counter()
        out[name] = IN.debug_solve_report(o, params, z0, settings)
        out[name]["s"] = time.perf_counter() - t0
    got, want = out["device"], out["cpu"]
    err = max(abs(float(got["iterations"][k][0]) -
                  float(want["iterations"][k][0])) /
              max(1.0, abs(float(want["iterations"][k][0])))
              for k in IN.IterTrace._fields)
    ranked = sorted(got["viol_sol"].items(), key=lambda kv: -kv[1])[:3]
    log(f"  debug_solve_report ({n_iter} IPM iterations) on {dev.type}: "
        f"{got['s']:.2f} s, on the CPU {want['s']:.2f} s; first iteration's "
        f"nine trace rows max rel err {err:.3e} (bound {OBSERVE_DEBUG_TOL}); "
        f"worst {got['worst']['name']} {got['worst']['row']} "
        f"{got['worst']['value']:.3e} (CPU: {want['worst']['name']} "
        f"{want['worst']['row']} {want['worst']['value']:.3e}); top classes "
        f"{[(k, f'{v:.3e}') for k, v in ranked]}; eq_viol "
        f"{got['info']['eq_viol']:.3e} / {want['info']['eq_viol']:.3e}")
    assert err <= OBSERVE_DEBUG_TOL, err
    assert got["worst"]["name"] == want["worst"]["name"], (got["worst"],
                                                          want["worst"])


def observe_stream(K, device, seconds):
    """scripts/real_robot_loop_torch.py on host case STREAM_CASE; returns
    (its JSON line, the kernel's launches)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import real_robot_loop_torch as RL

    K.kde_loglik.launches = 0
    out = _json_out(RL.main, ["--case", str(STREAM_CASE), "--duration_s",
                              str(seconds), "--device", str(device)])[-1]
    launches = K.kde_loglik.launches
    log(f"  stream (real_robot_loop_torch.py --case {STREAM_CASE} "
        f"--duration_s {seconds}): {json.dumps(out)}; {launches} "
        f"kde_loglik launches (the warm-up step and {out['ticks']} ticks)")
    assert out["ticks"] >= 1 and math.isfinite(out["latency_p50_ms"])
    if torch.device(device).type == "cuda":
        assert launches == out["ticks"] + 1, (launches, out["ticks"])
    return out, launches


def phase_observe(K, device="cuda", n_episodes=BATCH,
                  plain_steps=OBSERVE_PLAIN_STEPS,
                  fused_steps=OBSERVE_FUSED_STEPS, n_iter=MPC_IPM_ITERS,
                  gate_cases=GATE_CASES, stream_s=STREAM_SECONDS):
    """The observation path, the plain controller, the solver's
    introspection and the streaming controller (plain, fused, debug,
    stream). The keyword arguments exist for the CPU rehearsal
    (tests/test_torch_realtime.py). Returns the kernel's launches on the
    phase's paths (fused and stream). Logs each part's seconds."""
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        t1 = time.perf_counter()
        log(f"  [{name}] {t1 - t0:.2f} s")
        t0 = t1

    ocp, state, carry = observe_plain(device, n_episodes, plain_steps,
                                      n_iter, gate_cases)
    part("plain")
    fused = observe_fused(K, device, n_episodes, fused_steps, n_iter)
    part("fused")
    observe_debug(ocp, state, carry, n_iter)
    part("debug")
    _, stream = observe_stream(K, device, stream_s)
    part("stream")
    return fused + stream


def _script(name):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import importlib
    return importlib.import_module(name)


def _captured(fn, *args, **kwargs):
    """fn's return value and its standard output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return ret, buf.getvalue()


def _kde_path(K, fn):
    """Run fn() with the kernel's launch count set to 0 just before it and
    every kde_loglik_fused input recorded; returns (fn's value, the
    launches, the inputs)."""
    from sicnav_tpu_torch.diffusion import kde as KDE
    ranked = []

    def kept(orig):
        def f(preds, bandwidth):
            ranked.append((preds, bandwidth))
            return orig(preds, bandwidth)
        return f

    restore = _wrap(KDE, "kde_loglik_fused", kept)
    K.kde_loglik.launches = 0
    try:
        out = fn()
    finally:
        launches = K.kde_loglik.launches
        restore()
    return out, launches, ranked


def _held(K, device, ranked, launches, shape, n):
    """The path's n kernel inputs have ``shape``; on the card each was a
    launch and is held against the plain version."""
    assert len(ranked) == n, (len(ranked), n)
    for preds, _ in ranked:
        assert tuple(preds.shape) == shape, (tuple(preds.shape), shape)
    if torch.device(device).type == "cuda":
        assert launches == n, (launches, n)
        check_live_kde(K, ranked)


def tools_config():
    from sicnav_tpu_torch import config as CF
    env_path = os.path.join(ROOT, "configs", "env.config")
    pol_path = os.path.join(ROOT, "configs", "policy.config")
    env = CF.load_env_config(env_path)
    mpc = CF.load_mpc_config(pol_path, env)
    digest = CF.config_hash(env_path, pol_path)
    log(f"  configs/env.config + policy.config: scenario {env.scenario}, "
        f"{env.human_num} humans in {env.max_humans} slots, robot radius "
        f"{env.robot_radius}, robot_nx {mpc.robot_nx}, hum_model "
        f"{mpc.hum_model}, horizon {mpc.horiz}, config_hash {digest}")
    assert env.scenario == "hallway_bottleneck" and env.human_num == 3
    assert mpc.robot_nx == 4 and mpc.hum_model == "orca_casadi_kkt"
    assert len(digest) == 32


def tools_simple(K, device, n_iter, debug_steps, out_dir):
    """simple_test_torch.py: the DWA episode to its end, then the fused
    controller's debug steps; returns the kernel's launches."""
    import pickle

    import numpy as np
    ST = _script("simple_test_torch")
    dwa_pkl = os.path.join(out_dir, "dwa.pkl")
    t0 = time.perf_counter()
    summary, _ = _captured(ST.main, [
        "--policy", "dwa", "--hallway_bottleneck", "--env_config",
        os.path.join(ROOT, "configs", "env.config"), "--output_pickle",
        dwa_pkl, "--device", str(device)])
    with open(dwa_pkl, "rb") as f:
        assert pickle.load(f) == summary
    log(f"  simple_test --policy dwa --env_config configs/env.config, case "
        f"0: success {summary['success']}, timeout {summary['timeout']}, "
        f"{summary['steps']} steps, nav time {summary['nav_time']:.2f} s, "
        f"collisions {summary['collisions']}, wall "
        f"{time.perf_counter() - t0:.2f} s")
    assert summary["steps"] >= 1 and (summary["success"] or
                                      summary["timeout"])

    dbg_pkl = os.path.join(out_dir, "debug.pkl")
    t0 = time.perf_counter()
    (summary, _), launches, ranked = _kde_path(K, lambda: _captured(
        ST.main, ["--policy", "sicnav_diffusion", "--checkpoint", WEIGHTS,
                  "--debug_pickle", dbg_pkl, "--ipm_iters", str(n_iter),
                  "--device", str(device)], max_steps=debug_steps))
    wall = time.perf_counter() - t0
    with open(dbg_pkl, "rb") as f:
        dbg = pickle.load(f)
    solves = dbg["solves"]
    assert len(solves) == debug_steps and dbg["summary"] == summary
    for s in solves:
        assert set(s) == DEBUG_KEYS, set(s) ^ DEBUG_KEYS
        for k, v in s["trace"].items():
            assert v.shape == (n_iter,) and np.isfinite(v).all(), (k, v)
    _held(K, device, ranked, launches, PROTOCOL_KDE_SHAPE, debug_steps)
    worst = [(s["worst"]["row"], f"{s['worst']['value']:.3e}")
             for s in solves]
    log(f"  simple_test --policy sicnav_diffusion --debug_pickle, "
        f"{debug_steps} steps at {n_iter} IPM iterations: {wall:.2f} s; "
        f"solves used the guess {[s['used_guess'] for s in solves]}, "
        f"final merit {[float(s['trace']['merit'][-1]) for s in solves]}, "
        f"worst rows {worst}; {launches} kde_loglik launches on "
        f"{tuple(ranked[0][0].shape)}")
    return launches


def tools_audit(K, device, n_iter, n_cases, out_dir):
    """suite_audit_torch.py on n_cases cases as one batch, then its resume;
    returns the kernel's launches."""
    import shutil
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env.rollout import EpisodeStats
    import numpy as np
    SA = _script("suite_audit_torch")
    CT = _script("collision_taxonomy_torch")
    TT = _script("timeout_taxonomy_torch")
    resume = os.path.join(out_dir, "audit")
    shutil.rmtree(resume, ignore_errors=True)
    argv = ["--policy", "sicnav_diffusion", "--checkpoint", WEIGHTS,
            "--num_cases", str(n_cases), "--batch", str(n_cases),
            "--time_limit", str(TOOLS_AUDIT_TIME), "--ipm_iters",
            str(n_iter), "--resume_dir", resume, "--device", str(device)]
    steps = int(TOOLS_AUDIT_TIME / 0.25) + 2
    t0 = time.perf_counter()
    (report, text), launches, ranked = _kde_path(
        K, lambda: _captured(SA.main, argv))
    wall = time.perf_counter() - t0
    assert json.loads(text) == json.loads(json.dumps(report))
    _held(K, device, ranked, launches, (8 * n_cases, 48, 6), steps)

    z = np.load(os.path.join(resume, "batch_00000.npz"))
    stats = EpisodeStats(**{k: z[f"s_{k}"] for k in EpisodeStats._fields})
    cfg = dataclasses.replace(protocol_env(), time_limit=TOOLS_AUDIT_TIME)
    assert report["summary"] == harness.summarize(stats, cfg), \
        report["summary"]
    for kind, rows, counts, names in (
            ("collision", "collision_episodes", "collision_classes",
             CT.COLLISION_CLASSES),
            ("wall", "wall_episodes", "wall_classes", CT.COLLISION_CLASSES),
            ("timeout", "timeout_episodes", "timeout_classes",
             TT.TIMEOUT_CLASSES)):
        cases = [r["case"] for r in report[rows]]
        assert len(cases) == len(set(cases)), (kind, cases)
        assert sum(report[counts].values()) == len(cases), (kind, report[counts])
        for r in report[rows]:
            assert r["class"] in names, r["class"]
    assert report["n_timeouts"] == len(report["timeout_episodes"]) == \
        int(stats.timeout.sum())
    assert len(report["collision_episodes"]) == \
        int((stats.collision_steps > 0).sum())
    log(f"  suite_audit --policy sicnav_diffusion, {n_cases} cases as one "
        f"batch, {steps} traced steps at {n_iter} IPM iterations: "
        f"{wall:.2f} s; summary success {report['summary']['success_rate']}"
        f", timeout {report['summary']['timeout_rate']}; timeout classes "
        f"{report['timeout_classes']}, collision classes "
        f"{report['collision_classes']}, wall classes "
        f"{report['wall_classes']}; cascade guess step freq "
        f"{report['frozen_audit']['cascade_guess_step_freq']:.3f}; "
        f"{launches} kde_loglik launches on {tuple(ranked[0][0].shape)}")

    t0 = time.perf_counter()
    (again, _), relaunches, reranked = _kde_path(
        K, lambda: _captured(SA.main, argv))
    log(f"  the same call again from --resume_dir: {time.perf_counter() - t0:.2f}"
        f" s, {relaunches} launches, {len(reranked)} forecasts, report "
        f"{'equal' if again == report else 'DIFFERENT'}")
    assert relaunches == 0 and not reranked and again == report
    return launches


def tools_bench(K, device, n_iter, reps):
    """bench_control_step_torch.py's rows; returns the kernel's
    launches."""
    BC = _script("bench_control_step_torch")
    args = BC.parse_args(["--ipm_iters", str(n_iter), "--device",
                          str(device)])
    t0 = time.perf_counter()
    (out, ocp), launches, ranked = _kde_path(
        K, lambda: BC.measure(args, torch.device(device), reps=reps))
    log(f"  bench_control_step ({reps} calls a row, {n_iter} IPM "
        f"iterations): {json.dumps(out)}; {time.perf_counter() - t0:.2f} s;"
        f" {launches} kde_loglik launches")
    assert out["kkt_dim"] == ocp.cfg.n_z + ocp.n_eq == TOOLS_KKT_DIM, \
        (out["kkt_dim"], ocp.cfg.n_z, ocp.n_eq)
    for k in ("forecast_ms", "campc_solve_ms", "fused_step_ms",
              "kkt_solve_1x_ms", "kkt_solve_16x_ms"):
        assert math.isfinite(out[k]) and out[k] > 0, (k, out[k])
    # the forecast row and the fused row: a warm-up call and reps calls
    _held(K, device, ranked, launches, PROTOCOL_KDE_SHAPE, 2 * (reps + 1))
    return launches


def phase_tools(K, device="cuda", n_iter=MPC_IPM_ITERS,
                debug_steps=TOOLS_DEBUG_STEPS, n_cases=TOOLS_AUDIT_CASES,
                bench_reps=TOOLS_BENCH_REPS, out_dir=None):
    """The configs, the single-episode runner, the suite audit and the
    control-step decomposition (config, simple, audit, bench). The keyword
    arguments exist for the CPU rehearsal (tests/test_torch_tools_phase.py).
    Returns the kernel's launches on the phase's paths. Logs each part's
    seconds."""
    out_dir = out_dir or os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        t1 = time.perf_counter()
        log(f"  [{name}] {t1 - t0:.2f} s")
        t0 = t1

    tools_config()
    part("config")
    launches = tools_simple(K, device, n_iter, debug_steps, out_dir)
    part("simple")
    launches += tools_audit(K, device, n_iter, n_cases, out_dir)
    part("audit")
    launches += tools_bench(K, device, n_iter, bench_reps)
    part("bench")
    return launches


def orca_scenes(rng, n_scenes=40):
    """tests/test_native.py's scenes: n_scenes crowds of 2-6 agents, then
    n_scenes single agents among 1-3 random walls, as (pos, vel, rad,
    pref_vel, max_speed, walls) tuples."""
    agents, walls = [], []
    for _ in range(n_scenes):
        n = rng.integers(2, 7)
        agents.append((rng.uniform(-4, 4, (n, 2)), rng.uniform(-1, 1, (n, 2)),
                       rng.uniform(0.2, 0.5, n),
                       rng.uniform(-1.2, 1.2, (n, 2)),
                       rng.uniform(0.8, 1.6, n), None))
    for _ in range(n_scenes):
        pos, vel = rng.uniform(-3, 3, (1, 2)), rng.uniform(-1, 1, (1, 2))
        rad, pref, ms = [0.3], rng.uniform(-1, 1, (1, 2)), [1.2]
        segs = []
        for _ in range(rng.integers(1, 4)):
            a = rng.uniform(-3, 3, 2)
            segs.append((a, a + rng.uniform(-2, 2, 2)))
        walls.append((pos, vel, rad, pref, ms, segs))
    return agents, walls


def mesh_native(device):
    """The native ORCA oracle built with g++, and the port's batched ORCA
    on ``device`` held to it on tests/test_native.py's scenes."""
    import numpy as np
    from sicnav_tpu_torch.native import orca_cpp
    t0 = time.perf_counter()
    lib = orca_cpp.build_library()
    log(f"  native oracle {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    agents, walls = orca_scenes(np.random.default_rng(0))
    worst = 0.0
    for scene in agents:
        want = orca_cpp.orca_step_native(*scene)
        got = orca_cpp.orca_step_torch(*scene, device=device)
        worst = max(worst, float(np.linalg.norm(got - want, axis=-1).max()))
    errs = [float(np.linalg.norm(orca_cpp.orca_step_torch(*scene,
                                                          device=device) -
                                 orca_cpp.orca_step_native(*scene)))
            for scene in walls]
    bad = sum(e > ORCA_NATIVE_TOL for e in errs)
    log(f"  ops/orca on {device} against the native oracle: "
        f"{len(agents)} agent scenes, largest error {worst:.3e} (bound "
        f"{ORCA_NATIVE_TOL}); {len(walls)} wall scenes, {bad} over the "
        f"bound (at most {ORCA_WALL_MISMATCHES}), largest {max(errs):.3e}")
    assert worst < ORCA_NATIVE_TOL, worst
    assert bad <= ORCA_WALL_MISMATCHES, errs


def mesh_entry(device):
    """entry()'s forward on ``device`` against the same on the CPU (the
    same parameters: both drawn from seed 0 on the CPU)."""
    from sicnav_tpu_torch.entry import entry
    fn, args = entry(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    wall = time.perf_counter() - t0
    fn_cpu, args_cpu = entry("cpu")
    want = fn_cpu(*args_cpu)
    err = (out.cpu() - want).abs().max().item()
    log(f"  entry(): JMID forward of 4 scenes {tuple(out.shape)} in "
        f"{1e3 * wall:.2f} ms (first call); against the CPU max_abs_err "
        f"{err:.3e} (bound {MESH_ENTRY_TOL})")
    assert torch.isfinite(out).all() and err <= MESH_ENTRY_TOL, err


def mesh_dryrun(device, ranks):
    """entry.dryrun_multichip over ``ranks`` ranks on ``device``."""
    from sicnav_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    out = dryrun_multichip(ranks, device)
    m = out["mesh"]
    log(f"  dryrun_multichip({ranks}): backend {m['backend']}, world size "
        f"{m['size']}, rank devices {m['devices']}; env + DWA mean reward "
        f"{out['env_dwa']['mean_reward']:.4f}, JMID loss "
        f"{out['jmid_train']['loss']:.4f}, SARL loss "
        f"{out['sarl_train']['loss']:.4f}, fleet mean |action| "
        f"{out['fleet']['mean_abs_action']:.4f}; "
        f"{time.perf_counter() - t0:.2f} s")
    assert m["size"] == ranks
    return m


def _case_stats(path):
    """Every case's stats of a harness progress file, in case order."""
    import numpy as np
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env.rollout import EpisodeStats
    done = harness._load_progress(path)
    return EpisodeStats(*[np.concatenate([np.atleast_1d(getattr(done[k], f))
                                          for k in sorted(done)])
                          for f in EpisodeStats._fields])


def mesh_harness(device, ranks, n_cases, n_iter, time_limit, out_dir):
    """harness.evaluate_policy of the fused controller over protocol cases
    0..n_cases-1 sharded over ``ranks`` ranks, held to the one-process run
    at each rank's share as its batch (so that every solve has the same
    batch width). Returns the kernel's launches summed over the ranks."""
    import numpy as np
    from sicnav_tpu_torch.parallel import dryrun as DR
    from sicnav_tpu_torch.parallel.mesh import launch, make_mesh
    files = [os.path.join(out_dir, f"{name}.jsonl") for name in ("mesh", "one")]
    for f in files:
        if os.path.exists(f):
            os.remove(f)
    steps = int(time_limit / 0.25) + 2
    share = n_cases // ranks

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - t0

    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)     # as each CPU rank runs
    try:
        # the one-process run in a thread here, beside the ranks: checks,
        # not timings
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            one = pool.submit(timed, DR.harness_protocol,
                              make_mesh(device=device), WEIGHTS, n_cases,
                              share, n_iter, time_limit, files[1])
            # one batch of n_cases: each rank steps its n_cases / ranks
            sharded, wall = timed(launch, DR.harness_protocol, ranks,
                                  WEIGHTS, n_cases, n_cases, n_iter,
                                  time_limit, files[0], device=device)
            one, wall_one = one.result()
    finally:
        torch.set_num_threads(threads)
    per_rank = sharded["per_rank"]
    log(f"  evaluate_policy(mesh=) of the fused controller, cases 0-"
        f"{n_cases - 1}, {steps} steps at {n_iter} IPM iterations: backend "
        f"{sharded['backend']}, rank devices {sharded['devices']}, "
        f"{wall:.2f} s (the ranks' start included); one process at batch "
        f"{share}: {wall_one:.2f} s (the two at once)")
    log(f"  sharded: {json.dumps(sharded['summary'])}")
    log(f"  one process: {json.dumps(one['summary'])}")
    got, want = _case_stats(files[0]), _case_stats(files[1])
    flags = ("success", "timeout", "collision_steps", "wall_collision_steps",
             "frozen_steps", "steps")
    for name in got._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        diff = a != b if name in flags else np.abs(
            a.astype(np.float64) - b) > MESH_TIME_TOL
        if diff.any():
            log(f"  case stat {name} differs in cases "
                f"{np.flatnonzero(diff).tolist()}: sharded {a.tolist()}, "
                f"one process {b.tolist()}")
    for k, v in one["summary"].items():
        assert abs(sharded["summary"][k] - v) <= MESH_TIME_TOL, (k, v)
    for name in flags:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for r, (launches, n_inputs, err) in enumerate(per_rank.tolist()):
        log(f"  rank {r}: {launches:.0f} kde_loglik launches on "
            f"{sharded['kde_shapes']}, {n_inputs:.0f} inputs held to the "
            f"float64 plain version, max_abs_err {err:.3e} (bound "
            f"rtol=atol={KDE_TOL})")
        assert n_inputs == steps, (r, n_inputs, steps)
        if torch.device(device).type == "cuda":
            assert launches == steps, (r, launches, steps)
    assert sharded["kde_shapes"] == [(8 * share, 48, 6)]
    return int(per_rank[:, 0].sum().item())


def mesh_bench(device, batch, iters, reps):
    """bench_fleet_scaling_torch.py's rows at 1 and MESH_RANKS ranks."""
    BF = _script("bench_fleet_scaling_torch")
    args = BF.parse_args(["--devices", "1", str(MESH_RANKS), "--batch",
                          str(batch), "--iters", str(iters), "--reps",
                          str(reps), "--device", str(device)])
    t0 = time.perf_counter()
    rows, _ = _captured(BF.measure, args)
    for r in rows:
        log(f"  bench_fleet_scaling: {json.dumps(r)}")
        assert math.isfinite(r["solves_per_s"]) and r["solves_per_s"] > 0
    log(f"  bench_fleet_scaling at batch {batch}, {iters} IPM iterations, "
        f"{reps} timed steps a row: {time.perf_counter() - t0:.2f} s")
    assert [r["devices"] for r in rows] == [1, MESH_RANKS]


def phase_mesh(K, device="cuda", n_iter=MESH_IPM_ITERS, time_limit=MESH_TIME,
               n_cases=MESH_CASES, bench_batch=MESH_BENCH_BATCH,
               bench_iters=MESH_BENCH_ITERS, bench_reps=MESH_BENCH_REPS,
               out_dir=None):
    """The native ORCA oracle, entry(), the multi-rank dryrun, the sharded
    harness of the fused controller and the fleet bench (native, entry,
    dryrun, harness, bench), with MESH_RANKS ranks sharing the device. The
    keyword arguments exist for the CPU rehearsal
    (tests/test_torch_mesh_phase.py). Returns the kernel's launches summed
    over the ranks. Logs each part's seconds."""
    from sicnav_tpu_torch.parallel.mesh import plan
    out_dir = out_dir or os.path.join(ROOT, "build", "mesh")
    os.makedirs(out_dir, exist_ok=True)
    backend, devices = plan(MESH_RANKS, device)
    log(f"  {MESH_RANKS} ranks: backend {backend} (NCCL needs a card per "
        f"rank; {torch.cuda.device_count()} card(s) here), rank devices "
        f"{[str(d) for d in devices]}")
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        t1 = time.perf_counter()
        log(f"  [{name}] {t1 - t0:.2f} s")
        t0 = t1

    mesh_native(device)
    part("native")
    mesh_entry(device)
    part("entry")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the dryrun's ranks beside the harness's: neither is timed
        dry = pool.submit(mesh_dryrun, device, MESH_RANKS)
        launches = mesh_harness(device, MESH_RANKS, n_cases, n_iter,
                                time_limit, out_dir)
        dry.result()
    part("dryrun + harness")
    mesh_bench(device, bench_batch, bench_iters, bench_reps)
    part("bench")
    return launches


def state_tc(recipe, batch_size):
    """The recipe's TrainConfig at the batch size the data reached."""
    return dataclasses.replace(recipe.train, batch_size=batch_size)


def run_late(K, phases):
    """The named late phases in order. Returns the kernel's launches on
    each path and, with phase batch, its batched step's seconds and its
    profiled step's launches."""
    by_name = {"tools": phase_tools, "imid": phase_imid,
               "observe": phase_observe, "mesh": phase_mesh}
    result = {"launches_by_path": {}}
    for name in phases:
        with Phase(name):
            if name == "batch":
                ocp, model, settings, final, n = phase_batch(K,
                                                             measured=result)
                result["batch_launches_per_step"] = phase_profile_batch(
                    ocp, model, settings, final)
            else:
                n = by_name[name](K)
            result["launches_by_path"][name] = n
    return result


def _exit_on_term(signum, frame):
    # unwinds, so that finally blocks end the processes this one started
    sys.exit(128 + signum)


def late_main(phases, out):
    """``chip_smoke.py --late PHASES OUT``: the late phases named (comma
    separated) in this process, on the kernel library main built; what
    ``run_late`` returns goes to the JSON file OUT."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import ctypes
    signal.signal(signal.SIGTERM, _exit_on_term)
    # PR_SET_PDEATHSIG: SIGTERM here when the process that started this one
    # ends, however it ends
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)
    from sicnav_tpu_torch.ops import build
    from sicnav_tpu_torch.ops import kde_cuda as K
    build.load_library()
    result = run_late(K, phases.split(","))
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


class Beside:
    """A process started beside this one in a session of its own: its
    output lines are relayed through ``log`` behind ``prefix``, and it
    writes its result as JSON to ``out``."""

    def __init__(self, argv, out, prefix):
        self.out, self.prefix = out, prefix
        if os.path.exists(out):
            os.remove(out)
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=ROOT, start_new_session=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        self.relay = threading.Thread(target=self._relay, daemon=True)
        self.relay.start()

    def _relay(self):
        for line in self.proc.stdout:
            log(self.prefix + line.rstrip("\n"))

    def join(self, timeout):
        """Waits up to ``timeout`` s for the process and returns its JSON;
        raises if it failed or is still running."""
        try:
            rc = self.proc.wait(timeout=max(timeout, 0.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{self.proc.args} was still running after "
                               f"the deadline") from None
        self.relay.join()
        if rc != 0:
            raise RuntimeError(f"{self.proc.args} failed (exit code {rc})")
        with open(self.out) as f:
            return json.load(f)

    def stop(self):
        """Ends the process and every process of its session."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        self.relay.join(timeout=5)


def start_late(phases):
    """``chip_smoke.py --late`` for ``phases``, beside this process."""
    out = os.path.join(ROOT, "build", f"late_{'_'.join(phases)}.json")
    return Beside([sys.executable, os.path.abspath(__file__), "--late",
                   ",".join(phases), out], out, "+".join(phases) + " | ")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from sicnav_tpu_torch.ops import build
    from sicnav_tpu_torch.ops import kde_cuda as K

    signal.signal(signal.SIGTERM, _exit_on_term)
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
        check_ptxas(build.build_log)
    with Phase("kernels"):
        entry = phase_kernels(K)
    lates = []
    try:
        for phases in LATE_GROUPS:
            lates.append(start_late(phases))
            log(f"  phases {', '.join(phases)} started beside this process "
                f"(pid {lates[-1].proc.pid}); their lines begin "
                f"{lates[-1].prefix!r}")
        with Phase("slice"):
            model, slice_launches = phase_slice(K)
        measured = {}
        with Phase("mpc"):
            ocp, mpc_model, settings, record, mpc_launches = phase_mpc(
                K, measured=measured)
        with Phase("cross"):
            phase_cross(model)
            phase_cross_mpc(ocp, record, settings)
        with Phase("profile"):
            phase_profile(model)
            per_step = phase_profile_mpc(ocp, mpc_model, settings)
            if per_step is not None:
                log(f"  [mpc] launches per control step: {per_step:.0f}")
        by_path = {"mpc": mpc_launches, "slice": slice_launches}
        with Phase("harness"):
            phase_harness()
        with Phase("train"):
            by_path["train"] = phase_train(K)
        with Phase("rl"):
            K.kde_loglik.launches = 0
            phase_rl()
            by_path["rl"] = K.kde_loglik.launches
        with Phase("late"):
            batch = {}
            for late in lates:
                result = late.join(
                    LATE_DEADLINE_S - (time.perf_counter() - t_start))
                by_path.update(result.pop("launches_by_path"))
                batch.update(result)
            assert per_step is not None, "no unbatched launch count to hold to"
            per_step_b = batch["batch_launches_per_step"]
            log(f"  [batch] launches per batched control step: {per_step_b}, "
                f"{per_step_b / per_step:.3f}x the unbatched step's "
                f"{per_step:.0f} (bound {BATCH_LAUNCH_RATIO}x)")
            assert per_step_b <= BATCH_LAUNCH_RATIO * per_step, (per_step_b,
                                                                 per_step)
            b1, rate = measured["b1_step_s"], BATCH / batch["batch_step_s"]
            log(f"  [batch] {rate:.4f} episode-steps/s at B = {BATCH}; B = 1 "
                f"(mpc phase): {1 / b1:.4f} episode-steps/s, "
                f"{rate * b1:.2f}x")
    finally:
        for late in lates:
            late.stop()
    entry["launches"] = by_path["batch"]
    entry["launches_by_path"] = by_path
    log(f"total {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--late"]:
        sys.exit(late_main(*sys.argv[2:4]))
    sys.exit(main())

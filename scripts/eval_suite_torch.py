#!/usr/bin/env python3
"""The seeded evaluation suite on the PyTorch port (twin of
scripts/eval_suite.py for the port's policies).

    python scripts/eval_suite_torch.py --policy dwa --num_cases 10 --batch 10
    python scripts/eval_suite_torch.py --policy sicnav_diffusion \
        --num_cases 500 --batch 10 --progress_file build/accept.jsonl
    python scripts/eval_suite_torch.py --policy sarl \
        --checkpoint weights/sarl_200k.npz --scenario circle_crossing \
        --time_limit 15 --num_cases 200 --batch 50
    python scripts/eval_suite_torch.py --policy campc --privileged \
        --noise_std 0.05 --kalman_filter --num_cases 500

Takes every option of scripts/eval_suite.py. Runs
``harness.evaluate_policy`` over host cases 0..num_cases-1 (case == seed)
in batches of ``--batch`` episodes that advance together, one batched
control step at a time, and prints ``harness.summarize``'s dict as one
JSON line. The environment is built as the reference script builds it:
ORCA humans in circle crossing and ORCA-plus humans elsewhere, a holonomic
robot for ``--policy orca_plus`` and a unicycle robot otherwise. Its
defaults are the definitive protocol's (hallway bottleneck, 3 humans in 3
slots starting at once, 30 s, 122 steps, batch 10), not the reference
script's (circle crossing, 15 s, batch 50).

- ``--policy sicnav_diffusion`` is the fused controller with the trained
  JMID weights (``--weights``, or ``--checkpoint``; 48 samples, KDE top
  10) and ``IPMSettings(n_iter=--ipm_iters)``, so the second command above
  is the acceptance run.
- ``--policy campc|campc_cvmm`` is the plain SICNav controller (with
  ``--privileged`` SICNav-p) or MPC-CVMM, ``campc.make_policy(batch=True)``
  on the MPCConfig the reference script builds (wall margin 0.05 and
  door-yield off unless asked). The fourth command is the robustness
  table's filtered SICNav-p row.
- ``--noise_std`` and ``--kalman_filter`` wrap either MPC policy in the
  observation path as the reference does: the filter inside the noise.
- ``--policy sarl|rgl`` acts greedily on a value network
  (``--checkpoint``, an ``.npz`` of the port's state_dict, e.g.
  ``weights/sarl_200k.npz``; the third command is the records'
  circle-crossing evaluation), and ``--policy orca_plus`` drives the robot
  with ORCA-plus.

A rerun with the same ``--progress_file`` skips the batches it already
holds. ``--traced OUT.npz`` (an MPC policy) runs the batches through
``rollout.rollout_episode_traced`` instead and writes the episode stats
(``s_*``), the per-step StepTrace (``t_*``, (cases, steps, ...)) and the
per-step CAMPCAux (``a_*``) to OUT.npz; it keeps no progress file.

Runs on CUDA unless ``--device cpu``. Imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MPC_POLICIES = ("sicnav_diffusion", "campc", "campc_cvmm")


def parse_kv(spec: str) -> dict:
    """``k=v,k=v`` as a dict of bools, floats, ints or strings (the
    reference's ``scripts/audit_common._parse_kv``)."""
    out = {}
    for item in spec.split(","):
        k, v = item.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        elif "." in v or "e" in v or "inf" in v:
            out[k] = float(v)
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        epilog="Port-only options: --device, --weights, --traced, "
               "--seed_per_case. Defaults that differ from "
               "scripts/eval_suite.py: the definitive protocol's hallway "
               "bottleneck (not circle crossing), 30 s (not 15) and batch "
               "10 (not 50).")
    p.add_argument("--policy", default="dwa",
                   choices=["dwa", "orca_plus", "campc", "campc_cvmm",
                            "sarl", "rgl", "sicnav_diffusion"])
    p.add_argument("--checkpoint", default=None,
                   help="the value network of --policy sarl|rgl (an .npz of "
                        "the port's state_dict: weights/sarl_200k.npz, "
                        "weights/rgl_200k.npz or train_rl_torch.py's --out); "
                        "for sicnav_diffusion the JMID weights, in place of "
                        "--weights")
    p.add_argument("--noise_std", type=float, default=0.0,
                   help="robustness eval: Gaussian observation noise std "
                        "on the human positions and velocities")
    # sicnav_diffusion model and ablation knobs
    p.add_argument("--encoder_dim", type=int, default=128)
    p.add_argument("--tf_layer", type=int, default=2)
    p.add_argument("--num_samples", type=int, default=48)
    p.add_argument("--num_ret_samples", type=int, default=10)
    p.add_argument("--ddim_stride", type=int, default=2,
                   help="DDIM stride (NFE = 100/stride)")
    p.add_argument("--goal_dynamics", action="store_true",
                   help="stateful MID-sample weight dynamics (default: "
                        "static weighted goals)")
    p.add_argument("--door_yield", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="door-yield protocol; default on for "
                        "sicnav_diffusion, off for campc|campc_cvmm")
    p.add_argument("--no_close_to_preds", action="store_true",
                   help="ablation: drop the sample-spread constraint")
    p.add_argument("--ral", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the RA-L robot (8-state model, capsule, acados "
                        "slacks; default); --no-ral the T-RO 4-state circle")
    p.add_argument("--num_cases", type=int, default=500)
    p.add_argument("--time_limit", type=float, default=30.0,
                   help="seconds (default: the protocol's 30; the reference "
                        "script's is 15)")
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--scenario", default="hallway_bottleneck",
                   help="default: the definitive protocol's; the reference "
                        "script's is circle_crossing")
    p.add_argument("--phase", default="test", choices=["test", "val"])
    p.add_argument("--batch", type=int, default=10,
                   help="episodes per batched control step (the reference "
                        "script's default is 50)")
    p.add_argument("--progress_file", default=None,
                   help="JSONL per-batch checkpoint; completed batches are "
                        "skipped on rerun")
    p.add_argument("--privileged", action="store_true",
                   help="campc|campc_cvmm: SICNav-p, the humans' true goals "
                        "and preferred speeds")
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--soc", action="store_true",
                   help="IPM second-order correction steps")
    p.add_argument("--ipm_early_exit", type=float, default=0.0,
                   help="KKT-residual early-exit tolerance; 0 keeps the "
                        "fixed trip count")
    p.add_argument("--ref_type", default="point_stab",
                   choices=["point_stab", "goal_tile"])
    # the cascade's safety knobs (defaults: MPCConfig's)
    p.add_argument("--stage_margin", type=float, default=0.0,
                   help="per-stage human-collision margin growth (m/stage)")
    p.add_argument("--wall_margin", type=float, default=None,
                   help="extra wall clearance (m); default 0.05 for "
                        "campc|campc_cvmm, 0.10 (RA-L) or 0.05 (T-RO) for "
                        "sicnav_diffusion")
    p.add_argument("--brake_horizon", type=int, default=0,
                   help="leading stages of the guess's brake check (0 = "
                        "the full horizon)")
    p.add_argument("--brake_on_unreal_guess",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="brake when the adopted guess's exact rollout "
                        "predicts a collision")
    p.add_argument("--hard_wall_stages", type=int, default=0,
                   help="leading stages whose robot-wall rows are hard")
    p.add_argument("--evasive_brake", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="max-clearance 5-candidate brake fan")
    p.add_argument("--wall_aware_realism",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="the exact-rollout realism check includes walls")
    p.add_argument("--accept_margin", type=float, default=0.0,
                   help="least exact-rollout clearance (m) of a realistic "
                        "plan")
    p.add_argument("--brake_margin", type=float, default=0.0,
                   help="least exact-rollout clearance (m) of the adopted "
                        "guess before the brake fires")
    p.add_argument("--rescue_best_margin",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="multi-start: execute the best exact-margin start "
                        "instead of braking")
    p.add_argument("--multi_start", type=int, default=1,
                   help="NLP starts per control step (1 = single start)")
    p.add_argument("--adaptive_effort", type=int, default=0,
                   help="extra IPM iterations for a step whose previous "
                        "solve the cascade rejected")
    p.add_argument("--kalman_filter", action="store_true",
                   help="constant-velocity Kalman filter on the human "
                        "observations before the policy sees them; composes "
                        "inside --noise_std")
    p.add_argument("--kf_accel_std", type=float, default=2.0,
                   help="KFConfig.accel_std process-noise scale")
    p.add_argument("--dwa_nv", type=int, default=8,
                   help="DWA static-window v samples")
    p.add_argument("--dwa_nw", type=int, default=64,
                   help="DWA static-window yaw-rate samples")
    p.add_argument("--mpc_kw", default=None,
                   help="extra MPCConfig fields as k=v,k=v, applied after "
                        "the named flags")
    p.add_argument("--allow_random_params", action="store_true",
                   help="evaluate sarl|rgl WITHOUT a checkpoint (parameters "
                        "drawn from seed 0; ablation only)")
    # port-only options
    p.add_argument("--traced", default=None, metavar="OUT.npz",
                   help="port only: write per-step StepTrace and CAMPCAux to "
                        "OUT.npz (sicnav_diffusion, campc, campc_cvmm)")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    p.add_argument("--weights",
                   default=os.path.join(ROOT, "weights", "jmid_hallway.npz"),
                   help="port only: the JMID weights of sicnav_diffusion")
    p.add_argument("--seed_per_case", action="store_true",
                   help="port only: seed each episode's forecaster noise "
                        "with its case (default: seed 0 for every episode)")
    args = p.parse_args(argv)
    if args.traced and args.policy not in MPC_POLICIES:
        p.error("--traced records the MPC's per-step aux: it needs "
                "--policy sicnav_diffusion, campc or campc_cvmm")
    if (args.policy in ("sarl", "rgl") and not args.checkpoint
            and not args.allow_random_params):
        p.error(f"--policy {args.policy} requires --checkpoint (pass "
                "--allow_random_params to knowingly evaluate random "
                "weights); refusing to silently benchmark garbage")
    return args


def env_config(args):
    """The reference script's environment: ORCA humans in circle crossing,
    ORCA-plus elsewhere; a holonomic robot for ORCA-plus, else a unicycle."""
    from sicnav_tpu_torch.env.types import EnvConfig
    return EnvConfig(
        scenario=args.scenario,
        human_policy=("orca" if args.scenario == "circle_crossing"
                      else "orca_plus"),
        human_num=args.num_humans, max_humans=args.num_humans,
        starts_moving=0, time_limit=args.time_limit,
        robot_kinematics=("holonomic" if args.policy == "orca_plus"
                          else "unicycle"))


def value_policy(args, env_cfg, device, record=None):
    """The batched greedy policy of --policy sarl|rgl on --checkpoint's
    weights; with ``record`` each step's Q-values are appended to it."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import make_network

    net = make_network(args.policy, device=device)
    if args.checkpoint:
        net.load_state_dict(load_npz(args.checkpoint))
    net.eval()
    dqn = D.DQNConfig()
    actions = D.build_action_space(env_cfg, dqn, device)
    return D.greedy_policy(net, env_cfg, dqn, actions, record)


def ipm_settings(args):
    from sicnav_tpu_torch.mpc import ipm
    return ipm.IPMSettings(n_iter=args.ipm_iters, soc=args.soc,
                           early_exit_tol=args.ipm_early_exit)


def cascade_overrides(args):
    """The cascade flags as MPCConfig fields."""
    return {"stage_margin": args.stage_margin,
            "brake_on_unreal_guess": args.brake_on_unreal_guess,
            "brake_horizon": args.brake_horizon,
            "multi_start": args.multi_start,
            "adaptive_effort": args.adaptive_effort,
            "hard_wall_stages": args.hard_wall_stages,
            "evasive_brake": args.evasive_brake,
            "wall_aware_realism": args.wall_aware_realism,
            "accept_margin": args.accept_margin,
            "brake_margin": args.brake_margin,
            "rescue_best_margin": args.rescue_best_margin}


def campc_config(args, env_cfg):
    """The plain controller's MPCConfig, built as the reference script
    builds it: the RA-L switch as sicnav_diffusion's, wall margin 0.05 and
    door-yield off unless asked, then --mpc_kw."""
    from sicnav_tpu_torch.mpc.ocp import MPCConfig
    cfg = MPCConfig(
        num_hums=env_cfg.max_humans, num_walls=env_cfg.wall_slots,
        dt=env_cfg.dt,
        hum_model=("cvmm" if args.policy == "campc_cvmm"
                   else "orca_casadi_kkt"),
        priviledged_info=args.privileged, ref_type=args.ref_type,
        robot_nx=8 if args.ral else 4, robot_capsule=args.ral,
        term_q_coeff=75.0 if args.ral else 100.0,
        slack_mode="acados" if args.ral else "tro",
        wall_margin=(args.wall_margin if args.wall_margin is not None
                     else 0.05),
        door_yield=bool(args.door_yield), **cascade_overrides(args))
    if args.mpc_kw:
        cfg = dataclasses.replace(cfg, **parse_kv(args.mpc_kw))
    return cfg


def sicnav_diffusion_overrides(args):
    """The mpc_overrides the reference script hands
    sicnav_diffusion.make_policy."""
    return {**cascade_overrides(args),
            **({"wall_margin": args.wall_margin}
               if args.wall_margin is not None else {}),
            **(parse_kv(args.mpc_kw) if args.mpc_kw else {})}


def kf_config(args, env_cfg):
    from sicnav_tpu_torch.utils.state_filter import KFConfig
    return KFConfig(dt=env_cfg.dt, pos_std=max(args.noise_std, 0.05),
                    vel_std=max(args.noise_std, 0.05),
                    accel_std=args.kf_accel_std)


def noise_config(args):
    from sicnav_tpu_torch.utils.robustness import NoiseConfig
    return NoiseConfig(args.noise_std, args.noise_std)


def observed(args, env_cfg, device, init_carry_fn, step_fn):
    """The batched policy seen through the observation path: the Kalman
    filter (--kalman_filter) inside the noise (--noise_std)."""
    from sicnav_tpu_torch.utils import robustness as RB
    from sicnav_tpu_torch.utils import state_filter as SF
    if args.kalman_filter:
        step_fn = SF.filtered_policy_stateful(step_fn,
                                              kf_config(args, env_cfg))
        inner_init = init_carry_fn

        def init_carry_fn(cases):
            return (SF.init_filter(env_cfg.max_humans, batch=len(cases),
                                   device=device), inner_init(cases))
    if args.noise_std > 0:
        step_fn = RB.noisy_policy_stateful(step_fn, noise_config(args))
    return init_carry_fn, step_fn


def sicnav_diffusion_policy(args, env_cfg, device, aux=False):
    """(init_carry_fn, step_fn) of the batched fused controller."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    model = JMIDModel(ModelConfig(context_dim=args.encoder_dim,
                                  tf_layer=args.tf_layer), device=device)
    model.load_state_dict(load_npz(args.checkpoint or args.weights))
    fcfg = FC.ForecasterConfig(num_samples=args.num_samples,
                               num_ret_samples=args.num_ret_samples,
                               ddim_stride=args.ddim_stride, dt=env_cfg.dt)
    _, init_carry_fn, step_fn = SD.make_policy(
        env_cfg, model, fcfg=fcfg, settings=ipm_settings(args),
        goal_dynamics=args.goal_dynamics,
        close_to_preds=not args.no_close_to_preds, ral=args.ral,
        door_yield=(args.door_yield if args.door_yield is not None
                    else True),
        mpc_overrides=sicnav_diffusion_overrides(args), device=device,
        batch=True, seed_per_case=args.seed_per_case, aux=aux)
    return observed(args, env_cfg, device, init_carry_fn, step_fn)


def campc_policy(args, env_cfg, device, aux=False):
    """(init_carry_fn, step_fn) of the batched plain controller (SICNav,
    SICNav-p with --privileged, MPC-CVMM with campc_cvmm)."""
    from sicnav_tpu_torch.mpc import campc as C
    _, init_carry_fn, step_fn = C.make_policy(
        env_cfg, campc_config(args, env_cfg), settings=ipm_settings(args),
        device=device, batch=True, aux=aux)
    return observed(args, env_cfg, device, init_carry_fn, step_fn)


def mpc_policy(args, env_cfg, device, aux=False):
    make = (sicnav_diffusion_policy if args.policy == "sicnav_diffusion"
            else campc_policy)
    return make(args, env_cfg, device, aux)


def run_traced(args, env_cfg, device):
    """Batches through rollout_episode_traced; returns the summary and
    writes the traces to args.traced."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.env import crowd_sim, rollout

    init_carry_fn, step_fn = mpc_policy(args, env_cfg, device, aux=True)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    parts = []
    for start in range(0, args.num_cases, args.batch):
        cases = list(range(start, min(start + args.batch, args.num_cases)))
        states = crowd_sim.reset_batch(env_cfg, cases, args.phase, device)
        _, stats, trace = rollout.rollout_episode_traced(
            states, init_carry_fn(cases), step_fn, env_cfg, max_steps)
        flat = {f"s_{k}": v for k, v in stats._asdict().items()}
        flat.update({f"t_{k}": v for k, v in trace._asdict().items()
                     if k != "aux"})
        flat.update({f"a_{k}": v for k, v in trace.aux._asdict().items()})
        parts.append({k: v.cpu().numpy() for k, v in flat.items()})
        print(f"[traced] cases {start}-{cases[-1]} done", file=sys.stderr,
              flush=True)
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    np.savez(args.traced, **out)
    stats = rollout.EpisodeStats(*[out[f"s_{k}"]
                                   for k in rollout.EpisodeStats._fields])
    return harness.summarize(stats, env_cfg)


def main(argv=None):
    args = parse_args(argv)
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.policies.dwa import DWAConfig, dwa_policy_batch
    from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

    device = resolve_device(args.device)
    env_cfg = env_config(args)
    if args.traced:
        res = run_traced(args, env_cfg, device)
    elif args.policy in MPC_POLICIES:
        res = harness.evaluate_policy(
            None, env_cfg, args.num_cases, args.phase, args.batch,
            stateful_policy=mpc_policy(args, env_cfg, device),
            progress_file=args.progress_file, device=device)
    else:
        if args.policy == "dwa":
            dcfg = DWAConfig(max_speed=env_cfg.robot_v_pref,
                             min_speed=-env_cfg.robot_v_pref,
                             robot_radius=env_cfg.robot_radius,
                             dt=env_cfg.dt, n_v=args.dwa_nv,
                             n_w=args.dwa_nw)
            policy = lambda s: dwa_policy_batch(s, env_cfg, dcfg)  # noqa: E731
        elif args.policy in ("sarl", "rgl"):
            policy = value_policy(args, env_cfg, device)
        else:
            policy = lambda s: orca_robot_action(s, env_cfg)  # noqa: E731
        res = harness.evaluate_policy(
            policy, env_cfg, args.num_cases, args.phase, args.batch,
            progress_file=args.progress_file, device=device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

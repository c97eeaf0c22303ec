"""Shared setup of the port's episode-audit scripts (twin of
scripts/audit_common.py): the controller flags and the traced-suite
runner that the collision and timeout taxonomies and the combined suite
audit consume.

The seeded suite runs in batches of ``--batch`` episodes through
``rollout.rollout_episode_traced`` with the batched MPC step, recording
each step's events and the cascade's ``CAMPCAux``. ``--resume_dir`` keeps
one ``.npz`` per batch in the reference's layout (``s_*`` episode stats,
``t_*`` the step trace, ``a_*`` the aux; arrays (cases, steps, ...)), so
a batch file written by either package loads in the other, and a rerun
loads the batches it finds instead of running them. Imports no JAX.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def add_policy_args(p: argparse.ArgumentParser):
    p.add_argument("--policy", default="campc",
                   choices=["campc", "campc_cvmm", "sicnav_diffusion"])
    p.add_argument("--checkpoint", default=None,
                   help="JMID weights of --policy sicnav_diffusion, an .npz "
                        "of the port's state_dict (weights drawn from seed "
                        "0 if omitted)")
    p.add_argument("--scenario", default="hallway_bottleneck")
    p.add_argument("--num_cases", type=int, default=100)
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--batch", type=int, default=25)
    p.add_argument("--phase", default="test")
    p.add_argument("--time_limit", type=float, default=None,
                   help="episode time limit in s (default: env default 15; "
                        "the RA-L definitive-suite protocol uses 30)")
    p.add_argument("--ipm_iters", type=int, default=30)
    p.add_argument("--soc", action="store_true",
                   help="IPM second-order correction steps")
    p.add_argument("--privileged", action="store_true")
    p.add_argument("--ral", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--stage_margin", type=float, default=0.0)
    p.add_argument("--wall_margin", type=float, default=None,
                   help="default: 0.10 for sicnav_diffusion with --ral, "
                        "else 0.05")
    p.add_argument("--brake_on_unreal_guess",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="override MPCConfig.brake_on_unreal_guess")
    p.add_argument("--mpc_kw", default=None,
                   help="extra MPCConfig fields as k=v,k=v (floats/ints/bools)")
    p.add_argument("--resume_dir", default=None,
                   help="directory for per-batch traced-run .npz checkpoints "
                        "(completed batches are loaded, not re-run)")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p


def mpc_fields(args, env_cfg) -> dict:
    """The MPCConfig fields of the audited controller, in the reference's
    order: the RA-L switch, the margins, the brake override, --mpc_kw, then
    for the fused controller privileged information, close-to-preds, the
    ten served samples and door-yield unless --mpc_kw set it."""
    from eval_suite_torch import parse_kv

    fused = args.policy == "sicnav_diffusion"
    if args.wall_margin is not None:
        wall_margin = args.wall_margin
    elif fused and args.ral:
        wall_margin = 0.10
    else:
        wall_margin = 0.05
    kw = dict(
        num_hums=env_cfg.max_humans, num_walls=env_cfg.wall_slots,
        dt=env_cfg.dt,
        hum_model="cvmm" if args.policy == "campc_cvmm" else "orca_casadi_kkt",
        priviledged_info=args.privileged,
        robot_nx=8 if args.ral else 4, robot_capsule=args.ral,
        term_q_coeff=75.0 if args.ral else 100.0,
        slack_mode="acados" if args.ral else "tro",
        stage_margin=args.stage_margin, wall_margin=wall_margin)
    if args.brake_on_unreal_guess is not None:
        kw["brake_on_unreal_guess"] = args.brake_on_unreal_guess
    if args.mpc_kw:
        kw.update(parse_kv(args.mpc_kw))
    if fused:
        kw.update(priviledged_info=True, close_to_preds=True,
                  num_mid_samples=10)
        kw.setdefault("door_yield", True)
    return kw


def env_config(args):
    from sicnav_tpu_torch.env.types import EnvConfig
    env_kw = {"time_limit": args.time_limit} if args.time_limit else {}
    return EnvConfig(
        scenario=args.scenario,
        human_policy=("orca" if args.scenario == "circle_crossing"
                      else "orca_plus"),
        human_num=args.num_humans, max_humans=args.num_humans,
        starts_moving=0, robot_kinematics="unicycle", **env_kw)


def build(args, device):
    """(env_cfg, step_fn, init_carry, max_steps): ``step_fn(states,
    carries) -> (actions, carries, CAMPCAux)`` is the batched control step
    of the requested policy with ``aux=True``, ``init_carry(cases)`` the
    cases' stacked carries (every forecaster generator seeded 0)."""
    from sicnav_tpu_torch.mpc import campc as C, ipm
    from sicnav_tpu_torch.mpc.ocp import MPCConfig

    env_cfg = env_config(args)
    mpc_cfg = MPCConfig(**mpc_fields(args, env_cfg))
    settings = ipm.IPMSettings(n_iter=args.ipm_iters, soc=args.soc)
    if args.policy == "sicnav_diffusion":
        import torch
        from sicnav_tpu_torch.convert import load_npz
        from sicnav_tpu_torch.diffusion import forecaster as FC
        from sicnav_tpu_torch.diffusion.mid import JMIDModel
        from sicnav_tpu_torch.diffusion.models import (ModelConfig,
                                                       init_parameters)
        from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
        model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2),
                          joint=True, device=device)
        if args.checkpoint:
            model.load_state_dict(load_npz(os.path.abspath(args.checkpoint)))
        else:
            init_parameters(model, torch.Generator().manual_seed(0))
        fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                   dt=env_cfg.dt)
        _, init_carry, step_fn = SD.make_policy(
            env_cfg, model, mpc_cfg=mpc_cfg, fcfg=fcfg, settings=settings,
            device=device, batch=True, aux=True)
    else:
        _, init_carry, step_fn = C.make_policy(
            env_cfg, mpc_cfg, settings=settings, device=device, batch=True,
            aux=True)
    max_steps = int(env_cfg.time_limit / env_cfg.dt) + 2
    return env_cfg, step_fn, init_carry, max_steps


# the StepTrace fields handed to the taxonomies (the policy's aux pytree
# is keyed separately)
_TR_FIELDS = ("dmin", "collision", "wall_collision", "frozen", "live",
              "r_pos", "h_pos", "action", "latch", "door_stall")


def _aux_fields_from_npz(path):
    return [k[2:] for k in np.load(path).files if k.startswith("a_")]


def _save(path, stats, trace_np):
    flat = {f"s_{k}": np.asarray(getattr(stats, k)) for k in stats._fields}
    flat.update({f"t_{k}": v for k, v in trace_np.items() if k != "aux"})
    flat.update({f"a_{k}": v for k, v in trace_np["aux"].items()})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _load(path, stats_cls, aux_fields, tr_fields):
    z = np.load(path)
    stats = stats_cls(**{k: z[f"s_{k}"] for k in stats_cls._fields})
    tr = {k: z[f"t_{k}"] for k in tr_fields}
    tr["aux"] = {k: z[f"a_{k}"] for k in aux_fields}
    return stats, tr


def run_traced_suite(args, env_cfg, step_fn, init_carry, max_steps,
                     device=None):
    """Run the seeded suite in batched traced rollouts on ``device`` (CUDA
    unless named); returns (numpy EpisodeStats, trace dict of numpy
    arrays (cases, steps, ...) with the aux under "aux")."""
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.env import crowd_sim, rollout

    device = resolve_device(device)
    resume_dir = getattr(args, "resume_dir", None)
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)

    all_stats, all_traces = [], []
    for start in range(0, args.num_cases, args.batch):
        cases = list(range(start, min(start + args.batch, args.num_cases)))
        ckpt = (os.path.join(resume_dir, f"batch_{start:05d}.npz")
                if resume_dir else None)
        if ckpt and os.path.exists(ckpt):
            stats, trace_np = _load(ckpt, rollout.EpisodeStats,
                                    aux_fields=_aux_fields_from_npz(ckpt),
                                    tr_fields=_TR_FIELDS)
            all_stats.append(stats)
            all_traces.append(trace_np)
            print(f"[audit] cases {start}-{cases[-1]}: resumed from {ckpt}",
                  file=sys.stderr, flush=True)
            continue
        states = crowd_sim.reset_batch(env_cfg, cases, args.phase, device)
        _, stats, trace = rollout.rollout_episode_traced(
            states, init_carry(cases), step_fn, env_cfg, max_steps)
        stats = rollout.EpisodeStats(*[x.cpu().numpy() for x in stats])
        trace_np = {k: getattr(trace, k).cpu().numpy() for k in _TR_FIELDS}
        trace_np["aux"] = {f: v.cpu().numpy()
                           for f, v in trace.aux._asdict().items()}
        if ckpt:
            _save(ckpt, stats, trace_np)
        print(f"[audit] cases {start}-{cases[-1]}: success "
              f"{float(np.mean(np.atleast_1d(stats.success))):.2f}",
              file=sys.stderr, flush=True)
        all_stats.append(stats)
        all_traces.append(trace_np)

    stats = type(all_stats[0])(*[np.concatenate(xs)
                                 for xs in zip(*all_stats)])
    # max_steps is fixed across batches, so the time axes align
    tr = {k: np.concatenate([t[k] for t in all_traces]) for k in _TR_FIELDS}
    tr["aux"] = {k: np.concatenate([t["aux"][k] for t in all_traces])
                 for k in all_traces[0]["aux"]}
    return stats, tr

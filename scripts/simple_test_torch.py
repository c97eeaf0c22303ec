#!/usr/bin/env python3
"""Run one seeded test case end to end with a chosen robot policy, on the
PyTorch port (twin of scripts/simple_test.py).

    python scripts/simple_test_torch.py --policy dwa --hallway_bottleneck \
        --env_config configs/env.config --output_pickle build/dwa.pkl
    python scripts/simple_test_torch.py --policy sicnav_diffusion \
        --checkpoint weights/jmid_hallway.npz --debug_pickle build/debug.pkl
    python scripts/simple_test_torch.py --policy campc --test_case 3 \
        --video build/case3.gif

Takes every option of the reference script. One episode of host case
``--test_case`` (case == seed) with a per-step event log and a summary
dict (``--output_pickle``); the MPC policies can record each solve's
introspection (``--debug_pickle``: the IPM iteration table, the named
constraint violations of the solution and of the adopted plan, the
cascade's choice and the worst row) and render the episode with the
plan, guess and forecast overlays (``--video``, which needs matplotlib).

- ``--policy campc|campc_cvmm``: the plain controller on the default
  MPCConfig (``--privileged``: SICNav-p); ``--policy_config`` replaces the
  whole MPCConfig with the INI file's, as the reference's does.
- ``--policy sicnav_diffusion``: the fused controller; ``--checkpoint`` is
  the JMID predictor, an ``.npz`` of the port's state_dict (e.g.
  weights/jmid_hallway.npz); without it the predictor's weights are drawn
  from seed 0. Its forecaster noise comes from a generator seeded with
  the test case.
- Without ``--ipm_iters`` the solver runs ``ipm.realtime_settings``'
  per-crowd-size iteration caps.

Runs on CUDA unless ``--device cpu`` (port only). Imports no JAX.
"""

import argparse
import os
import pickle
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MPC_POLICIES = ("campc", "campc_cvmm", "sicnav_diffusion")


def parse_args(argv=None):
    p = argparse.ArgumentParser(epilog="Port-only option: --device.")
    p.add_argument("--policy", default="campc",
                   choices=["campc", "campc_cvmm", "dwa", "orca_plus",
                            "sicnav_diffusion"])
    p.add_argument("--test_case", type=int, default=0)
    p.add_argument("--num_humans", type=int, default=3)
    p.add_argument("--circle", action="store_true")
    p.add_argument("--hallway", action="store_true")
    p.add_argument("--hallway_static", action="store_true")
    p.add_argument("--hallway_bottleneck", action="store_true")
    p.add_argument("--hallway_squeeze", action="store_true")
    p.add_argument("--env_config", default=None)
    p.add_argument("--policy_config", default=None)
    p.add_argument("--video", default=None, help="output mp4/gif path")
    p.add_argument("--ipm_iters", type=int, default=None,
                   help="IPM iterations (default: per-crowd realtime caps)")
    p.add_argument("--output_pickle", default=None)
    p.add_argument("--debug_pickle", default=None,
                   help="persist per-step solver introspection: IPM "
                        "iteration tables + named constraint violations")
    p.add_argument("--checkpoint", default=None,
                   help="JMID weights (.npz of the port's state_dict) for "
                        "--policy sicnav_diffusion")
    p.add_argument("--privileged", action="store_true",
                   help="SICNav-p (true human goals) vs SICNav-np")
    p.add_argument("--device", default=None,
                   help="port only: torch device (default: cuda)")
    return p.parse_args(argv)


def env_config(args):
    """The reference script's environment: hallway bottleneck with
    ORCA-plus humans unless a scenario switch says otherwise (circle
    crossing with ORCA humans), from ``--env_config`` when given."""
    from sicnav_tpu_torch.env.types import EnvConfig

    scenario = "hallway_bottleneck"
    human_policy = "orca_plus"
    if args.circle:
        scenario, human_policy = "circle_crossing", "orca"
    elif args.hallway:
        scenario = "hallway"
    elif args.hallway_static:
        scenario = "hallway_static"
    elif args.hallway_squeeze:
        scenario = "hallway_squeeze"
    if args.env_config:
        from sicnav_tpu_torch.config import load_env_config
        return load_env_config(args.env_config, scenario_override=scenario,
                               human_num_override=args.num_humans)
    return EnvConfig(scenario=scenario, human_policy=human_policy,
                     human_num=args.num_humans, max_humans=args.num_humans,
                     robot_kinematics="holonomic"
                     if args.policy == "orca_plus" else "unicycle")


def jmid_model(args, device):
    """The shipped hallway predictor's widths; ``--checkpoint``'s weights
    or weights drawn from seed 0."""
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig, init_parameters

    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2), joint=True,
                      device=device)
    if args.checkpoint:
        model.load_state_dict(load_npz(os.path.abspath(args.checkpoint)))
    else:
        init_parameters(model, torch.Generator().manual_seed(0))
    return model


def build_policy(args, cfg, device):
    """The policy of ``--policy``: a namespace with ``act(state, carry) ->
    (action, carry)`` (``(action, carry, SolveDebug)`` for an MPC policy
    when ``debug``), its initial ``carry`` (None for DWA and ORCA-plus),
    the ``ocp`` of an MPC policy and, for the fused controller,
    ``forecast(state, carry)``: the forecast the next action will serve."""
    pol = SimpleNamespace(carry=None, ocp=None, forecast=None,
                          debug=bool(args.debug_pickle or args.video)
                          and args.policy in MPC_POLICIES)
    if args.policy in ("campc", "campc_cvmm"):
        from sicnav_tpu_torch.mpc import campc as C
        from sicnav_tpu_torch.mpc import ipm
        from sicnav_tpu_torch.mpc.ocp import MPCConfig
        mpc_cfg = MPCConfig(
            num_hums=cfg.max_humans, num_walls=cfg.wall_slots, dt=cfg.dt,
            hum_model=("cvmm" if args.policy == "campc_cvmm"
                       else "orca_casadi_kkt"),
            priviledged_info=args.privileged)
        if args.policy_config:
            from sicnav_tpu_torch.config import load_mpc_config
            mpc_cfg = load_mpc_config(args.policy_config, cfg)
        settings = (ipm.IPMSettings(n_iter=args.ipm_iters) if args.ipm_iters
                    else ipm.realtime_settings(cfg.max_humans))
        ocp, policy = C.make_policy(cfg, mpc_cfg, settings=settings,
                                    device=device)
        pol.ocp, pol.carry = ocp, C.init_carry(ocp)
        pol.act = policy
        if pol.debug:
            pol.act = lambda s, c: C.campc_action(ocp, s, c, cfg, settings,
                                                  debug=True)
    elif args.policy == "dwa":
        from sicnav_tpu_torch.policies.dwa import dwa_policy
        pol.act = lambda s, c: (dwa_policy(s, cfg), None)
    elif args.policy == "orca_plus":
        from sicnav_tpu_torch.policies.orca_robot import orca_robot_action
        pol.act = lambda s, c: (orca_robot_action(s, cfg), None)
    else:
        from sicnav_tpu_torch.diffusion import forecaster as FC
        from sicnav_tpu_torch.mpc import ipm
        from sicnav_tpu_torch.mpc import sicnav_diffusion as SD
        model = jmid_model(args, device)
        fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                   dt=cfg.dt)
        settings = (ipm.IPMSettings(n_iter=args.ipm_iters) if args.ipm_iters
                    else ipm.realtime_settings(cfg.max_humans, with_mid=True))
        ocp, policy = SD.make_policy(cfg, model, fcfg=fcfg,
                                     settings=settings, device=device)
        pol.ocp = ocp
        pol.carry = SD.init_carry(ocp, cfg.max_humans, fcfg,
                                  seed=args.test_case)
        pol.act = policy
        if pol.debug:
            pol.act = lambda s, c: SD.sicnav_diffusion_action(
                ocp, model, s, c, cfg, fcfg, settings, debug=True)

        def forecast(state, carry):
            # the draw the action will make: a copy of its generator
            gen = torch.Generator(device=carry.generator.device)
            gen.set_state(carry.generator.get_state())
            fst = FC.update_state_hists(carry.forecaster, state, fcfg)
            return FC.predict_ret_best(model, fst, state, fcfg,
                                       generator=gen)

        pol.forecast = forecast
    return pol


def _host(x):
    """A debug tree (NamedTuples, dicts, tensors) as numpy."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_host(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x.detach().cpu().numpy()


def debug_entry(ocp, step_i, dbg):
    """One solve's record, key for key the reference's."""
    from sicnav_tpu_torch.mpc import introspection as IN
    name, val, flat = IN.argmax_violated(dbg.viol_used)
    return dict(
        step=step_i,
        trace={k: np.asarray(v) for k, v in dbg.trace._asdict().items()},
        info={k: float(v) for k, v in dbg.info._asdict().items()},
        viol_sol={k: float(v.max_viol) for k, v in dbg.viol_sol.items()},
        viol_used={k: float(v.max_viol) for k, v in dbg.viol_used.items()},
        used_guess=bool(dbg.used_guess),
        sol_cost=float(dbg.sol_cost),
        guess_cost=float(dbg.guess_cost),
        slack_max=float(dbg.slack_max),
        worst=dict(name=name, value=val,
                   row=IN.describe_row(ocp, name, flat)))


def run_episode(args, cfg, pol, state, max_steps):
    """Step the episode until it is done or ``max_steps`` steps have run.
    Returns (summary, debug records, the states, the overlays)."""
    from sicnav_tpu_torch.env import crowd_sim as CS

    log, states, debug_steps = [], [state], []
    overlays = dict(plans=[], guesses=[], hplans=[], fc=[], fw=[])
    want_overlays = bool(args.video) and args.policy in MPC_POLICIES
    carry = pol.carry
    t0 = time.time()
    for step_i in range(max_steps):
        if want_overlays and pol.forecast is not None:
            fc, lw = pol.forecast(state, carry)
            overlays["fc"].append(fc.cpu().numpy())
            overlays["fw"].append(lw.cpu().numpy())
        if pol.debug:
            action, carry, dbg = pol.act(state, carry)
            dbg = _host(dbg)
            if want_overlays:
                overlays["plans"].append(dbg.plan)
                overlays["guesses"].append(dbg.guess_plan)
                overlays["hplans"].append(dbg.human_plans)
            debug_steps.append(debug_entry(pol.ocp, step_i, dbg))
            worst = debug_steps[-1]["worst"]
            if bool(dbg.used_guess) or worst["value"] > 1e-2:
                print(f"  [solve] used_guess={bool(dbg.used_guess)} "
                      f"worst={worst['row']} viol={worst['value']:.2e}")
        else:
            action, carry = pol.act(state, carry)
        state, rew, info = CS.step(state, action, cfg)
        states.append(state)
        ev = dict(step=step_i, t=float(state.t), reward=float(rew),
                  collision=bool(info.collision), danger=bool(info.danger),
                  frozen=bool(info.frozen),
                  wall_collision=bool(info.wall_collision),
                  dmin=float(info.dmin))
        log.append(ev)
        flags = "".join(k[0].upper() for k in
                        ("collision", "danger", "frozen", "wall_collision")
                        if ev[k])
        print(f"t={ev['t']:5.2f} pos=({float(state.r_pos[0]):+.2f},"
              f"{float(state.r_pos[1]):+.2f}) r={ev['reward']:+.3f} "
              f"dmin={ev['dmin']:.2f} {flags}")
        if bool(state.done):
            break

    success = bool(info.reach_goal)
    summary = dict(policy=args.policy, test_case=args.test_case,
                   success=success, timeout=bool(info.timeout),
                   nav_time=float(state.t), steps=len(log),
                   collisions=sum(e["collision"] for e in log),
                   wall_collisions=sum(e["wall_collision"] for e in log),
                   frozen=sum(e["frozen"] for e in log),
                   danger=sum(e["danger"] for e in log),
                   wall_time=time.time() - t0, log=log)
    outcome = ("SUCCESS" if success else
               "TIMEOUT" if summary["timeout"] else "UNFINISHED")
    print(f"\n{outcome} nav_time={summary['nav_time']:.2f}s "
          f"collisions={summary['collisions']} "
          f"wall_time={summary['wall_time']:.1f}s")
    return summary, debug_steps, states, overlays


def write_video(args, cfg, states, overlays):
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.utils.render import render_episode

    n = len(states)

    def pad_t(xs):
        return np.stack(xs + [xs[-1]] * (n - len(xs))) if xs else None

    ov = {}
    if overlays["plans"]:
        ov = dict(plans=pad_t(overlays["plans"]),
                  guesses=pad_t(overlays["guesses"]),
                  human_plans=pad_t(overlays["hplans"]))
    if overlays["fc"]:
        ov["forecasts"] = pad_t(overlays["fc"])
        ov["forecast_weights"] = pad_t(overlays["fw"])
    render_episode(CS.stack(states), cfg, args.video, **ov)
    print("wrote", args.video)


def main(argv=None, max_steps=None):
    """The CLI; ``max_steps`` (default: time_limit / dt + 2, the whole
    episode) cuts the episode short. Returns the summary."""
    args = parse_args(argv)
    from sicnav_tpu_torch.device import resolve_device
    from sicnav_tpu_torch.env import crowd_sim as CS

    device = resolve_device(args.device)
    cfg = env_config(args)
    state = CS.reset_host(cfg, case=args.test_case, device=device)
    if max_steps is None:
        max_steps = int(cfg.time_limit / cfg.dt) + 2
    pol = build_policy(args, cfg, device)
    summary, debug_steps, states, overlays = run_episode(args, cfg, pol,
                                                         state, max_steps)
    if args.output_pickle:
        with open(args.output_pickle, "wb") as f:
            pickle.dump(summary, f)
    if args.debug_pickle and debug_steps:
        with open(args.debug_pickle, "wb") as f:
            pickle.dump(dict(summary=summary, solves=debug_steps), f)
        print("wrote", args.debug_pickle,
              f"({len(debug_steps)} instrumented solves)")
    if args.video:
        write_video(args, cfg, states, overlays)
    return summary


if __name__ == "__main__":
    main()

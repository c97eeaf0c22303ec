"""SICNav-Diffusion: JMID forecasts fused into the CAMPC loop (twin of
``sicnav_tpu/mpc/sicnav_diffusion.py``).

Per control step: push the human positions into the forecaster's history,
serve a JMID forecast (diffusion sampling + KDE top-k), turn the ranked
samples into the MPC's human-goal model (the weighted sample average at
t+1) and its close-to-preds sample grid, and solve the bilevel MPC. The
default configuration is the reference's: the RA-L 8-state capsule robot
with the acados slack penalties, privileged information, close-to-preds,
door-yield on, wall margin 0.10.

A ``torch.Generator`` in the carry draws the forecaster's start noise, in
place of the reference's split PRNG key.

The batched policy (``make_policy(batch=True)``) advances B episodes with
one control step: the forecaster takes the B scenes as one batch (each
episode's noise from its own generator, its KDE ranking one kernel call of
B x horizon groups), then ``torch.func.vmap`` maps the MPC half
(``act_on_forecasts``) over the episodes, on an OCP built ``vmapped``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import vmap

from portbench.reference.frozen.diffusion import forecaster as FC
from portbench.reference.frozen.diffusion.mid import JMIDModel
from portbench.reference.frozen.env.crowd_sim import stack
from portbench.reference.frozen.env.types import EnvConfig, SimState
from portbench.reference.frozen.mpc import campc as C
from portbench.reference.frozen.mpc import ipm
from portbench.reference.frozen.mpc.ocp import MPCConfig, OCP


class SICNavDiffCarry(NamedTuple):
    """One episode's carry; for a batch the tensors carry a leading episode
    axis and ``generator`` is a list of generators, one per episode."""
    mpc: C.CAMPCCarry
    forecaster: FC.ForecasterState
    generator: torch.Generator


def init_carry(ocp: OCP, max_humans: int, fcfg: FC.ForecasterConfig,
               seed: int = 0) -> SICNavDiffCarry:
    gen = torch.Generator(device=ocp.device).manual_seed(seed)
    return SICNavDiffCarry(
        mpc=C.init_carry(ocp),
        forecaster=FC.init_state(max_humans, fcfg, device=ocp.device),
        generator=gen)


def init_batch_carry(ocp: OCP, max_humans: int, fcfg: FC.ForecasterConfig,
                     seeds) -> SICNavDiffCarry:
    """The carries of ``len(seeds)`` episodes, stacked on a leading axis;
    episode i's generator is seeded with ``seeds[i]``."""
    carries = [init_carry(ocp, max_humans, fcfg, s) for s in seeds]
    return SICNavDiffCarry(mpc=stack([c.mpc for c in carries]),
                           forecaster=stack([c.forecaster for c in carries]),
                           generator=[c.generator for c in carries])


def weighted_goals(forecasts, log_weights, step: int = 1):
    """Human goals = log-weight-averaged forecast positions at t+step.
    forecasts: (H, k, T+1, 2); log_weights: (H, k). Returns (H, 2)."""
    w = torch.softmax(log_weights, dim=-1)
    return torch.sum(w[..., None] * forecasts[:, :, step, :], dim=1)


def mpc_inputs(ocp: OCP, state: SimState, forecasts, log_w):
    """Served forecasts (H, k, T+1, 2) and log-weights (H, k) -> the MPC's
    inputs: (state with forecast goals, mid_samples (S, H, K+2, 2),
    mid_logw0 (S,), h_intent)."""
    goals = weighted_goals(forecasts, log_w)
    # the sample grid, the forecast horizon padded with its last step when
    # the MPC horizon reaches past it
    K = ocp.cfg.K
    fc = forecasts.permute(1, 0, 2, 3)
    T = fc.shape[2]
    if T < K + 2:
        fc = torch.cat([fc, fc[:, :, -1:].expand(-1, -1, K + 2 - T, -1)],
                       dim=2)
    # the MPC sees forecast goals; the door-yield transit test keeps the
    # observed h_goal (the t+1 forecast of a door-blocked human barely
    # moves, which would misread it as parked)
    h_intent = state.h_goal if ocp.cfg.door_yield else None
    return (state._replace(h_goal=goals), fc[:, :, :K + 2], log_w[0],
            h_intent)


def act_on_forecasts(ocp: OCP, state: SimState, mpc_carry: C.CAMPCCarry,
                     forecasts, log_w, env_cfg: EnvConfig,
                     settings: ipm.IPMSettings = ipm.IPMSettings(),
                     aux: bool = False, debug: bool = False):
    """The MPC half of a control step on served forecasts (H, k, T+1, 2)
    and log-weights (H, k). Returns (action, mpc_carry') (+ ``CAMPCAux``
    with ``aux``, else + ``introspection.SolveDebug`` with ``debug``)."""
    view, mid_samples, mid_logw0, h_intent = mpc_inputs(ocp, state,
                                                        forecasts, log_w)
    return C.campc_action(ocp, view, mpc_carry, env_cfg, settings,
                          mid_samples=mid_samples, mid_logw0=mid_logw0,
                          aux=aux, h_intent=h_intent, debug=debug)


def sicnav_diffusion_action(ocp: OCP, model: JMIDModel, state: SimState,
                            carry: SICNavDiffCarry, env_cfg: EnvConfig,
                            fcfg: FC.ForecasterConfig,
                            settings: ipm.IPMSettings = ipm.IPMSettings(),
                            aux: bool = False, debug: bool = False):
    """One SICNav-Diffusion control step. Returns (action (v, r), carry')
    (+ ``campc.CAMPCAux`` with ``aux=True``, else + the
    ``introspection.SolveDebug`` with ``debug=True``)."""
    fstate = FC.update_state_hists(carry.forecaster, state, fcfg)
    forecasts, log_w = FC.predict_ret_best(model, fstate, state, fcfg,
                                           generator=carry.generator)
    out = act_on_forecasts(ocp, state, carry.mpc, forecasts, log_w, env_cfg,
                           settings, aux=aux, debug=debug)
    new_carry = SICNavDiffCarry(mpc=out[1], forecaster=fstate,
                                generator=carry.generator)
    return (out[0], new_carry) + tuple(out[2:])


def act_on_forecasts_batch(ocp: OCP, states: SimState,
                           mpc_carry: C.CAMPCCarry, forecasts, log_w,
                           env_cfg: EnvConfig,
                           settings: ipm.IPMSettings = ipm.IPMSettings(),
                           aux: bool = False):
    """``act_on_forecasts`` of B episodes, ``torch.func.vmap``ped over the
    leading episode axis of every argument: one solve of the B NLPs, each
    launch carrying all of them. ``ocp`` must be built ``vmapped``."""
    if not ocp.vmapped:
        raise ValueError("act_on_forecasts_batch needs an OCP built with "
                         "vmapped=True")

    def one(state, carry, fc, lw):
        return act_on_forecasts(ocp, state, carry, fc, lw, env_cfg, settings,
                                aux=aux)

    with ipm.batched_lu_threads(ocp.device):
        return vmap(one)(states, mpc_carry, forecasts, log_w)


def sicnav_diffusion_action_batch(ocp: OCP, model: JMIDModel,
                                  states: SimState, carry: SICNavDiffCarry,
                                  env_cfg: EnvConfig,
                                  fcfg: FC.ForecasterConfig,
                                  settings: ipm.IPMSettings = ipm.IPMSettings(),
                                  aux: bool = False):
    """One control step of B episodes (``states`` and ``carry`` from
    ``init_batch_carry``): the batched forecaster, then the vmapped MPC
    half. Returns (actions (B, 2), carry') (+ ``CAMPCAux`` of (B,)
    tensors with ``aux=True``)."""
    fstate = FC.update_state_hists(carry.forecaster, states, fcfg)
    forecasts, log_w = FC.predict_ret_best(model, fstate, states, fcfg,
                                           generator=carry.generator)
    out = act_on_forecasts_batch(ocp, states, carry.mpc, forecasts, log_w,
                                 env_cfg, settings, aux=aux)
    new_carry = SICNavDiffCarry(mpc=out[1], forecaster=fstate,
                                generator=carry.generator)
    return (out[0], new_carry) + tuple(out[2:])


def make_policy(env_cfg: EnvConfig, model: JMIDModel, mpc_cfg=None,
                fcfg: FC.ForecasterConfig = None,
                settings: ipm.IPMSettings = None,
                goal_dynamics: bool = False, close_to_preds: bool = True,
                ral: bool = True, door_yield: bool = True,
                mpc_overrides: dict = None, device=None,
                batch: bool = False, seed_per_case: bool = False,
                aux: bool = False):
    """Build (ocp, policy_fn): policy_fn(state, carry) -> (action, carry),
    on ``device`` (CUDA unless named; the model must live there too).

    ``batch=True`` builds the batched policy instead: (ocp, init_carry_fn,
    step_fn) for ``rollout.batch_rollout_stateful`` and
    ``harness.evaluate_policy``. ``init_carry_fn(cases)`` gives the cases'
    stacked carries, every generator seeded 0 as the reference's audit
    does, or seeded with its case with ``seed_per_case``;
    ``step_fn(states, carries) -> (actions, carries)`` (+ aux with
    ``aux``) is one batched control step.

    The reference's defaults: static weighted-sample goals at t+1
    (``goal_dynamics`` off), the close-to-preds constraint, the RA-L robot
    (``ral``: 8-state model, capsule, acados slacks, terminal weight 75,
    wall margin 0.10; else the T-RO 4-state circle, 100, 0.05), door-yield
    on, and the MID-conditioned iteration caps."""
    if fcfg is None:
        fcfg = FC.ForecasterConfig(num_samples=48, num_ret_samples=10,
                                   dt=env_cfg.dt)
    if mpc_cfg is None:
        mpc_cfg = MPCConfig(num_hums=env_cfg.max_humans,
                            num_walls=env_cfg.wall_slots,
                            dt=env_cfg.dt, priviledged_info=True,
                            human_pred_mid=goal_dynamics,
                            close_to_preds=close_to_preds,
                            num_mid_samples=fcfg.num_ret_samples,
                            robot_nx=8 if ral else 4,
                            robot_capsule=ral,
                            term_q_coeff=75.0 if ral else 100.0,
                            slack_mode="acados" if ral else "tro",
                            wall_margin=0.10 if ral else 0.05,
                            door_yield=door_yield)
    if mpc_overrides:
        mpc_cfg = dataclasses.replace(mpc_cfg, **mpc_overrides)
    if settings is None:
        settings = ipm.realtime_settings(mpc_cfg.num_hums, with_mid=True)
    ocp = OCP(mpc_cfg, device=device, vmapped=batch)

    if batch:
        def init_carry_fn(cases):
            seeds = list(cases) if seed_per_case else [0] * len(cases)
            return init_batch_carry(ocp, env_cfg.max_humans, fcfg, seeds)

        def step_fn(states, carries):
            return sicnav_diffusion_action_batch(ocp, model, states, carries,
                                                 env_cfg, fcfg, settings,
                                                 aux=aux)

        return ocp, init_carry_fn, step_fn

    def policy_fn(state, carry):
        return sicnav_diffusion_action(ocp, model, state, carry, env_cfg,
                                       fcfg, settings)

    return ocp, policy_fn

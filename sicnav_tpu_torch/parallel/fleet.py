"""Sharded MPC fleet solves: a batch of CAMPC problems over a mesh (twin of
``sicnav_tpu/parallel/fleet.py``).

The scaling axis is a fleet of independent solves, one per environment or
evaluation case, batched into one control step
(``campc.make_policy(batch=True)``) and split over the ranks of a
``parallel.mesh.Mesh``, each rank solving its rows on its own device.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.mpc import campc, ipm
from sicnav_tpu_torch.mpc.ocp import MPCConfig
from sicnav_tpu_torch.parallel.mesh import Mesh, gather_batch, shard_batch


def make_fleet_policy(env_cfg: EnvConfig,
                      mpc_cfg: Optional[MPCConfig] = None,
                      settings: Optional[ipm.IPMSettings] = None,
                      device=None):
    """(ocp, fleet_fn) on ``device`` (CUDA unless named):
    ``fleet_fn(states, carries) -> (actions, carries)`` is one batched
    control step over a leading batch axis. Give each rank its rows
    (``parallel.mesh.shard_batch``) and the ranks split the solves."""
    ocp, _, fleet_fn = campc.make_policy(env_cfg, mpc_cfg, settings,
                                         device=device, batch=True)
    return ocp, fleet_fn


def fleet_inputs(env_cfg: EnvConfig, ocp, batch_size: int, seed: int,
                 mesh: Mesh):
    """This rank's rows of ``batch_size`` device resets drawn from
    ``seed`` (every rank draws the whole batch and keeps its rows), and
    their fresh carries."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    states = shard_batch(CS.reset_device(env_cfg, batch_size, gen,
                                         mesh.device), mesh)
    carries = CS.stack([campc.init_carry(ocp)
                        for _ in range(states.t.shape[0])])
    return states, carries


def demo_config(num_humans: int = 2):
    """The dryrun's fleet: circle crossing with ORCA humans, a unicycle
    robot, a two-step horizon and three IPM iterations."""
    env_cfg = EnvConfig(scenario="circle_crossing", human_policy="orca",
                        human_num=num_humans, max_humans=num_humans,
                        starts_moving=0, robot_kinematics="unicycle")
    mpc_cfg = MPCConfig(num_hums=num_humans, num_walls=env_cfg.wall_slots,
                        dt=env_cfg.dt, horiz=2, orca_kkt_horiz=2)
    return env_cfg, mpc_cfg, ipm.IPMSettings(n_iter=3)


def fleet_step(mesh: Mesh, batch_size: int, seed: int = 7) -> torch.Tensor:
    """One sharded fleet control step of ``demo_config`` on ``batch_size``
    resets; every rank returns the whole fleet's actions (B, 2)."""
    env_cfg, mpc_cfg, settings = demo_config()
    ocp, fleet_fn = make_fleet_policy(env_cfg, mpc_cfg, settings, mesh.device)
    actions, _ = fleet_fn(*fleet_inputs(env_cfg, ocp, batch_size, seed, mesh))
    return gather_batch(actions, mesh)


def fleet_solve_demo(mesh: Mesh, batch_size: int) -> torch.Tensor:
    """Dryrun stage: one sharded fleet CAMPC control step on tiny shapes.
    Returns the mean |action| across the fleet (finite iff solves ran)."""
    return fleet_step(mesh, batch_size).abs().mean()


def _sync(mesh: Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.size > 1:
        torch.distributed.barrier(group=mesh.group)


def measure(mesh: Mesh, batch_size: int, num_humans: int, n_iter: int,
            reps: int, seed: int = 0) -> dict:
    """Fleet solves per second of ``batch_size`` CAMPC problems (circle
    crossing, ``num_humans`` ORCA humans, the default horizon, ``n_iter``
    IPM iterations) split over the mesh: one warm-up step, then ``reps``
    timed steps, each from every rank's start to the last rank's finish
    (a barrier on both sides), the fastest kept."""
    env_cfg = EnvConfig(scenario="circle_crossing", human_policy="orca",
                        human_num=num_humans, max_humans=num_humans,
                        starts_moving=0, robot_kinematics="unicycle")
    mpc_cfg = MPCConfig(num_hums=num_humans, num_walls=env_cfg.wall_slots,
                        dt=env_cfg.dt)
    ocp, fleet_fn = make_fleet_policy(env_cfg, mpc_cfg,
                                      ipm.IPMSettings(n_iter=n_iter),
                                      mesh.device)
    states, carries = fleet_inputs(env_cfg, ocp, batch_size, seed, mesh)
    t0 = time.perf_counter()
    actions, _ = fleet_fn(states, carries)
    _sync(mesh)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        _sync(mesh)
        t0 = time.perf_counter()
        actions, _ = fleet_fn(states, carries)
        _sync(mesh)
        times.append(time.perf_counter() - t0)
    actions = gather_batch(actions, mesh)
    if not bool(torch.isfinite(actions).all()):
        raise RuntimeError("fleet solve gave non-finite actions")
    dt = min(times)
    return dict(devices=mesh.size, batch=batch_size,
                device=str(mesh.device), backend=mesh.backend,
                first_step_ms=1e3 * first, step_ms=1e3 * dt,
                solves_per_s=batch_size / dt)

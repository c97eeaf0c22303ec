"""Multi-rank dry run: the framework's data-parallel paths over an N-rank
mesh on tiny shapes (twin of ``sicnav_tpu/parallel/dryrun.py``).

    python -m sicnav_tpu_torch.parallel.dryrun N [--device cpu]

runs ``main`` in N ranks (``parallel.mesh.launch``: gloo ranks sharing the
device, or NCCL with a card per rank) and prints ``dryrun ok``. The four
stages of ``main`` mirror the reference's:

1. the env + DWA step over 2N states, its mean reward averaged over the
   ranks;
2. one JMID train step, the scenes sharded, the parameters replicated and
   the gradients averaged;
3. one SARL DQN train step on a sharded replay batch;
4. one sharded fleet CAMPC control step (``parallel.fleet``).

``STAGES`` also holds the sharded harness (DWA and the protocol's fused
controller) and the sharded DQN loop; ``run_stages`` runs any of them in
one launch. Each stage takes the mesh first and returns host values that
are the same on every rank, so a run in N ranks can be held to the same
stage on a one-rank mesh (``parallel.mesh.make_mesh()``).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.parallel.fleet import fleet_solve_demo, fleet_step
from sicnav_tpu_torch.parallel.mesh import (
    Mesh, all_mean, gather_batch, launch, replicate, shard_batch,
)

# the kernel's tolerance against its plain version in float64
KDE_TOL = 2e-4


def crowd_config(num_humans: int = 3, time_limit: float = 25.0):
    """Circle crossing with ORCA humans and a unicycle robot (the
    reference dryrun's and ``tests/test_parallel.py``'s environment)."""
    return EnvConfig(scenario="circle_crossing", human_policy="orca",
                     human_num=num_humans, max_humans=num_humans,
                     starts_moving=0, robot_kinematics="unicycle",
                     time_limit=time_limit)


def protocol_config(time_limit: float = 30.0):
    """The definitive protocol's environment: hallway bottleneck, 3
    ORCA-plus humans in 3 slots that start at once, a unicycle robot."""
    return EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                     human_num=3, max_humans=3, starts_moving=0,
                     time_limit=time_limit, robot_kinematics="unicycle")


def _sharded(mesh: Mesh):
    """The mesh to hand an entry point, or None on one rank: a stage on a
    one-rank mesh is the call without a mesh, which the sharded stage is
    held to."""
    return mesh if mesh.size > 1 else None


def env_dwa_step(mesh: Mesh, batch_size: int = None) -> dict:
    """Stage 1: one DWA action and env step of ``batch_size`` (2N) device
    resets; the final robot positions (B, 2) and the mean reward."""
    from sicnav_tpu_torch.policies.dwa import dwa_policy_batch
    B = batch_size or 2 * mesh.size
    cfg = crowd_config()
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    states = shard_batch(CS.reset_device(cfg, B, gen, mesh.device), mesh)
    s2, rew, _ = CS.step_masked(states, dwa_policy_batch(states, cfg), cfg)
    r_pos = gather_batch(s2.r_pos, mesh)
    if tuple(r_pos.shape) != (B, 2):
        raise RuntimeError(f"env step: r_pos {tuple(r_pos.shape)}")
    return {"r_pos": r_pos, "mean_reward": float(all_mean(rew.mean(), mesh))}


def jmid_train_step(mesh: Mesh, batch_size: int = None) -> dict:
    """Stage 2: one JMID train step (context 32, encoder 16, one layer) on
    ``batch_size`` (2N) scenes of three straight walkers."""
    from sicnav_tpu_torch.diffusion import data as D
    from sicnav_tpu_torch.diffusion.mid import (
        JMIDModel, TrainConfig, make_train_state, train_step,
    )
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    B = batch_size or 2 * mesh.size
    rng = np.random.default_rng(0)
    A, T = 3, 30
    pos = (rng.uniform(-2, 2, (A, 1, 2)) +
           rng.uniform(-1, 1, (A, 1, 2)) * np.arange(T)[None, :, None] * 0.25)
    examples = D.build_examples(pos, np.ones((A, T), bool), 0.25,
                                history_len=6, horizon=8, stride=8)
    scenes = D.stack_batches((examples * B)[:B]).to_tensors(mesh.device)
    model = JMIDModel(ModelConfig(context_dim=32, enc_rnn_dim=16, tf_layer=1),
                      joint=True, device=mesh.device)
    state = make_train_state(model, TrainConfig(), 1)
    replicate(model.state_dict(), mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    loss = float(train_step(model, state, shard_batch(scenes, mesh), gen,
                            mesh=mesh))
    if not np.isfinite(loss):
        raise RuntimeError(f"JMID train step: loss {loss}")
    return {"loss": loss}


def sarl_train_step(mesh: Mesh, params=None, target=None, batch=None,
                    lr: float = 1e-3, gamma: float = 0.9) -> dict:
    """Stage 3: one SARL fitted-value step (Adam at ``lr``), the parameters
    replicated from rank 0 and the replay batch sharded. ``params`` and
    ``target`` are state_dicts (a seed-0 network and itself by default),
    ``batch`` a ``dqn.Transition`` of arrays (2N zero transitions by
    default). Returns the loss and the updated state_dict."""
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import SARLNetwork
    net = SARLNetwork(device=mesh.device)
    if params is not None:
        net.load_state_dict(params)
    replicate(net.state_dict(), mesh)
    tgt = copy.deepcopy(net).requires_grad_(False)
    if target is not None:
        tgt.load_state_dict(target)
    if batch is None:
        B, H = 2 * mesh.size, crowd_config().max_humans
        z = np.zeros
        batch = D.Transition(z((B, 9)), z((B, H, 5)), np.ones((B, H), bool),
                             z((B, 9)), z((B, H, 5)), z(B), z(B, bool))
    batch = D.Transition(*[torch.as_tensor(
        x, dtype=torch.bool if np.asarray(x).dtype == bool else torch.float32,
        device=mesh.device) for x in batch])
    opt = D.make_optimizer(net, D.DQNConfig(lr=lr))
    loss = float(D.train_step(net, tgt, opt, shard_batch(batch, mesh), gamma,
                              mesh))
    if not np.isfinite(loss):
        raise RuntimeError(f"SARL train step: loss {loss}")
    return {"loss": loss, "params": net.state_dict()}


def fleet_demo(mesh: Mesh, batch_size: int = None) -> dict:
    """Stage 4: one sharded fleet CAMPC control step on ``batch_size``
    (2N) resets (``fleet.fleet_solve_demo``); its mean |action|."""
    mean_abs = float(fleet_solve_demo(mesh, batch_size or 2 * mesh.size))
    if not np.isfinite(mean_abs):
        raise RuntimeError(f"fleet solve: mean |action| {mean_abs}")
    return {"mean_abs_action": mean_abs}


def fleet_actions(mesh: Mesh, batch_size: int) -> dict:
    """The actions (B, 2) of stage 4's sharded fleet step."""
    return {"actions": fleet_step(mesh, batch_size)}


def harness_dwa(mesh: Mesh, num_cases: int, batch: int,
                time_limit: float) -> dict:
    """``harness.evaluate_policy`` of the batched DWA robot in
    ``crowd_config`` at ``time_limit``, the cases sharded over the mesh."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.policies.dwa import dwa_policy_batch
    cfg = crowd_config(time_limit=time_limit)
    return harness.evaluate_policy(
        lambda states: dwa_policy_batch(states, cfg), cfg, num_cases,
        batch=batch, mesh=_sharded(mesh), device=mesh.device)


@contextlib.contextmanager
def _recorded_kde(inputs):
    """Every ``kde_loglik_fused`` call of the forecaster's ranking appends
    its (preds, bandwidth) to ``inputs``."""
    from sicnav_tpu_torch.diffusion import kde
    orig = kde.kde_loglik_fused

    def recorded(preds, bandwidth):
        inputs.append((preds, bandwidth))
        return orig(preds, bandwidth)

    kde.kde_loglik_fused = recorded
    try:
        yield
    finally:
        kde.kde_loglik_fused = orig


def _held_kde(inputs):
    """The largest |kernel - plain| over ``inputs``, each whitened and
    ranked by ``ops/kde_cuda.kde_loglik`` and by its plain version in
    float64 (within KDE_TOL, NaN for NaN)."""
    from sicnav_tpu_torch.ops import kde_cuda as K
    err = 0.0
    for preds, bw in inputs:
        y, z = K.kde_whiten(preds, bw)
        got = K.kde_loglik(y, z).double()
        exact = K.kde_loglik_plain(y.double(), z.double())
        torch.testing.assert_close(got, exact, rtol=KDE_TOL, atol=KDE_TOL,
                                   equal_nan=True)
        ok = torch.isfinite(exact)
        if bool(ok.any()):
            err = max(err, (got[ok] - exact[ok]).abs().max().item())
    return err


def harness_protocol(mesh: Mesh, weights: str, num_cases: int, batch: int,
                     n_iter: int, time_limit: float,
                     progress_file: str = None) -> dict:
    """``harness.evaluate_policy`` of the fused SICNav-Diffusion controller
    (``sicnav_diffusion.make_policy(batch=True)``: the trained JMID from
    ``weights`` at its shipped widths, the protocol's MPC at
    ``IPMSettings(n_iter)``) on the protocol's environment cut to
    ``time_limit``, the cases sharded over the mesh (rank 0 writes
    ``progress_file``, each case's stats). Each rank
    records the forecaster's KDE inputs and counts the kernel's launches;
    on a card each input is then ranked again by the kernel and held to
    the plain version. Returns the summary, each rank's [launches,
    inputs, largest error] (size, 3) and the inputs' shapes."""
    from sicnav_tpu_torch import harness
    from sicnav_tpu_torch.convert import load_npz
    from sicnav_tpu_torch.diffusion.mid import JMIDModel
    from sicnav_tpu_torch.diffusion.models import ModelConfig
    from sicnav_tpu_torch.mpc import ipm, sicnav_diffusion
    from sicnav_tpu_torch.ops import kde_cuda as K
    cfg = protocol_config(time_limit)
    model = JMIDModel(ModelConfig(context_dim=128, tf_layer=2),
                      device=mesh.device)
    model.load_state_dict(load_npz(weights))
    _, init_carry_fn, step_fn = sicnav_diffusion.make_policy(
        cfg, model, settings=ipm.IPMSettings(n_iter=n_iter),
        device=mesh.device, batch=True)
    inputs = []
    launches = K.kde_loglik.launches
    with _recorded_kde(inputs):
        summary = harness.evaluate_policy(
            None, cfg, num_cases, batch=batch,
            stateful_policy=(init_carry_fn, step_fn),
            mesh=_sharded(mesh), progress_file=progress_file,
            device=mesh.device)
    launches = K.kde_loglik.launches - launches
    err = _held_kde(inputs) if mesh.device.type == "cuda" else 0.0
    shapes = sorted({tuple(p.shape) for p, _ in inputs})
    per_rank = gather_batch(torch.tensor(
        [[launches, len(inputs), err]], dtype=torch.float64,
        device=mesh.device), mesh)
    return {"summary": summary, "per_rank": per_rank, "kde_shapes": shapes,
            **layout(mesh)}


def dqn_train(mesh: Mesh, n_envs: int = 16, total_steps: int = 128,
              batch_size: int = 32, seed: int = 3) -> dict:
    """``dqn.train`` of SARL in ``crowd_config(2)`` (learning from step 32,
    the target every 2 collects), the environments sharded over the mesh.
    Returns the state_dict and history."""
    from sicnav_tpu_torch.rl import dqn as D
    from sicnav_tpu_torch.rl.networks import SARLNetwork
    dqn = D.DQNConfig(learning_starts=32, batch_size=batch_size,
                      target_update_interval=2)
    net = SARLNetwork(device=mesh.device)
    params, history = D.train(net, crowd_config(2), dqn, n_envs=n_envs,
                              seed=seed, total_steps=total_steps,
                              mesh=_sharded(mesh), device=mesh.device)
    return {"params": params, "history": history}


def layout(mesh: Mesh) -> dict:
    """The mesh's size, backend and every rank's device."""
    return {"size": mesh.size, "backend": mesh.backend,
            "devices": [str(d) for d in gather_devices(mesh)]}


STAGES = {"layout": layout, "env_dwa": env_dwa_step, "jmid_train": jmid_train_step,
          "sarl_train": sarl_train_step, "fleet": fleet_demo,
          "fleet_actions": fleet_actions, "harness_dwa": harness_dwa,
          "harness_protocol": harness_protocol, "dqn_train": dqn_train}
MAIN_STAGES = ("env_dwa", "jmid_train", "sarl_train", "fleet")


def run_stages(mesh: Mesh, stages) -> dict:
    """A rank body: each (name, kwargs) of ``stages`` run in turn on the
    mesh; {name: its result}."""
    return {name: STAGES[name](mesh, **kwargs) for name, kwargs in stages}


def main(mesh: Mesh) -> dict:
    """The dry run's four stages on the mesh (a rank body); their results
    and the mesh's layout."""
    out = run_stages(mesh, [(name, {}) for name in MAIN_STAGES])
    out["mesh"] = layout(mesh)
    return out


def gather_devices(mesh: Mesh):
    """Every rank's device, in rank order."""
    dev = mesh.device
    idx = -1 if dev.type == "cpu" else (dev.index or 0)
    got = gather_batch(torch.tensor([idx], device=dev), mesh).tolist()
    return [torch.device("cpu") if i < 0 else torch.device("cuda", i)
            for i in got]


def _parse(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


if __name__ == "__main__":
    import json

    args = _parse()
    out = launch(main, args.n, device=args.device)
    print(json.dumps({"mesh": out["mesh"],
                      "mean_reward": out["env_dwa"]["mean_reward"],
                      "jmid_loss": out["jmid_train"]["loss"],
                      "sarl_loss": out["sarl_train"]["loss"],
                      "fleet_mean_abs_action":
                          out["fleet"]["mean_abs_action"]}))
    print("dryrun ok")

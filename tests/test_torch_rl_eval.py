"""The port's RL evaluation (scripts/eval_suite_torch.py --policy
sarl|rgl|orca_plus) against the JAX reference's (scripts/eval_suite.py and
sicnav_tpu.harness), and the CPU rehearsal of chip_smoke.py's rl phase.

- ``env_config`` builds the environment the reference script builds for
  the same flags (captured from the reference's ``main``): ORCA humans in
  circle crossing, ORCA-plus elsewhere, a holonomic robot for orca_plus
  only.
- Greedy SARL and RGL from ``weights/{sarl,rgl}_200k.npz`` over
  circle-crossing host cases 0-3 (15 s, one batch): the script's summary
  equals the reference harness's on the Orbax checkpoint (counted rates
  exactly, the means of float statistics within 1e-5); on every live step
  of the port's episodes the reference's Q-values of the same state are
  within 1e-4 of the port's, and the greedy actions are equal wherever
  the top two differ by more than 1e-4.
- ORCA-plus as the robot over two cases: the same summary.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu import harness as H_ref
from sicnav_tpu.env import crowd_sim as CS_ref
from sicnav_tpu.env import types as T_ref
from sicnav_tpu.policies.orca_robot import orca_robot_action as orca_ref
from sicnav_tpu.rl import dqn as D_ref
from sicnav_tpu_torch import harness as H
from sicnav_tpu_torch.rl import dqn as D

from tests.test_torch_rl_networks import NETS, checkpoint_params

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import eval_suite as ES_ref  # noqa: E402
import eval_suite_torch as ES  # noqa: E402

FLOAT_KEYS = {"mean_nav_time", "mean_total_reward"}
Q_TOL = 1e-4
TIE = 1e-4
CIRCLE = ["--scenario", "circle_crossing", "--time_limit", "15"]


def _same_summary(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in FLOAT_KEYS:
            assert got[k] == pytest.approx(w, abs=1e-5), k
        else:
            assert got[k] == w, k


class _Captured(Exception):
    pass


def reference_env(monkeypatch, argv):
    """The EnvConfig scripts/eval_suite.py builds for ``argv``."""
    def capture(policy_fn, env_cfg, *args, **kwargs):
        raise _Captured(env_cfg)

    monkeypatch.setattr(H_ref, "evaluate_policy", capture)
    monkeypatch.setattr(sys, "argv", ["eval_suite.py"] + argv)
    with pytest.raises(_Captured) as e:
        ES_ref.main()
    return e.value.args[0]


@pytest.mark.parametrize("policy", ["dwa", "orca_plus", "sarl"])
@pytest.mark.parametrize("scenario", ["circle_crossing", "hallway_bottleneck"])
def test_env_config_matches_reference_script(monkeypatch, policy, scenario):
    argv = ["--policy", policy, "--scenario", scenario, "--time_limit", "20",
            "--num_humans", "4"]
    if policy == "sarl":
        argv.append("--allow_random_params")
    want = reference_env(monkeypatch, argv)
    got = ES.env_config(ES.parse_args(argv))
    assert got.human_policy == ("orca" if scenario == "circle_crossing"
                                else "orca_plus")
    assert got.robot_kinematics == ("holonomic" if policy == "orca_plus"
                                    else "unicycle")
    for field in ("scenario", "human_policy", "robot_kinematics", "human_num",
                  "max_humans", "starts_moving", "time_limit"):
        assert getattr(got, field) == getattr(want, field), field


def test_value_policies_need_a_checkpoint():
    for name in ("sarl", "rgl"):
        with pytest.raises(SystemExit):
            ES.parse_args(["--policy", name])
    assert ES.parse_args(["--policy", "rgl", "--allow_random_params"])


def _to_ref(x, like):
    """A port state (numpy leaves) as the reference's NamedTuple type."""
    if hasattr(like, "_fields"):
        return type(like)(*[_to_ref(a, b) for a, b in zip(x, like)])
    return jnp.asarray(x)


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_greedy_policy_matches_reference(name, capsys):
    weights = str(ROOT / "weights" / f"{name}_200k.npz")
    argv = ["--policy", name, "--checkpoint", weights, "--num_cases", "4",
            "--batch", "4", "--device", "cpu"] + CIRCLE
    assert ES.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    args = ES.parse_args(argv)
    cfg = ES.env_config(args)
    env_cfg_ref = T_ref.EnvConfig(**{k: getattr(cfg, k) for k in (
        "scenario", "human_policy", "human_num", "max_humans",
        "starts_moving", "time_limit", "robot_kinematics")})
    params = checkpoint_params(name)
    net_ref = NETS[name][0]()
    actions = D_ref.build_action_space(env_cfg_ref, D_ref.DQNConfig())
    q_ref = D_ref.make_q_fn(net_ref, env_cfg_ref, D_ref.DQNConfig(), actions)
    want = H_ref.evaluate_policy(
        lambda s: actions[jnp.argmax(q_ref(params, s))], env_cfg_ref, 4,
        "test", 4)
    _same_summary(got, want)
    assert got["success_rate"] == 1.0

    # every step's Q: the port's, and the reference's of the same states
    record, seen = [], []
    greedy = ES.value_policy(args, ES.env_config(args), "cpu", record)

    def policy(states):
        seen.append(states)
        return greedy(states)

    again = H.evaluate_policy(policy, ES.env_config(args), 4, batch=4,
                              device="cpu")
    _same_summary(again, got)
    q = torch.stack(record).numpy()                          # (T, B, A)
    live = ~torch.stack([s.done for s in seen]).numpy()
    stacked = jax.tree.map(lambda *xs: np.stack([x.numpy() for x in xs]),
                           *seen)
    like = CS_ref.reset_host(env_cfg_ref, 0)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), stacked)
    states_ref = _to_ref(flat, like)
    want_q = np.asarray(jax.jit(jax.vmap(lambda s: q_ref(params, s)))(
        states_ref)).reshape(q.shape)
    assert live.sum() > 40
    np.testing.assert_allclose(q[live], want_q[live], rtol=0, atol=Q_TOL)
    top2 = np.sort(want_q, axis=-1)[..., -2:]
    decided = live & ((top2[..., 1] - top2[..., 0]) > TIE)
    np.testing.assert_array_equal(q.argmax(-1)[decided],
                                  want_q.argmax(-1)[decided])


def test_orca_plus_robot_matches_reference(capsys):
    argv = ["--policy", "orca_plus", "--num_cases", "2", "--batch", "2",
            "--device", "cpu", "--scenario", "circle_crossing",
            "--time_limit", "4"]
    assert ES.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = ES.env_config(ES.parse_args(argv))
    assert cfg.robot_kinematics == "holonomic"
    env_cfg_ref = T_ref.EnvConfig(
        scenario="circle_crossing", human_policy="orca", human_num=3,
        max_humans=3, starts_moving=0, time_limit=4.0,
        robot_kinematics="holonomic")
    want = H_ref.evaluate_policy(lambda s: orca_ref(s, env_cfg_ref),
                                 env_cfg_ref, 2, "test", 2)
    _same_summary(got, want)


def test_chip_smoke_rl_rehearsal(tmp_path):
    """chip_smoke.py's rl phase at a small size on the CPU, and its
    card-vs-CPU gates run with the CPU on both sides."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from sicnav_tpu_torch.env import crowd_sim
    from sicnav_tpu_torch.rl.networks import make_network

    dqn = D.DQNConfig(learning_starts=16, batch_size=16, buffer_capacity=256)
    history = S.phase_rl(device="cpu", n_cases=2, il_episodes=4, il_epochs=1,
                         n_envs=4, collect_steps=8, dqn=dqn,
                         lookahead2_envs=2, out_dir=str(tmp_path))
    assert history and all(np.isfinite(h["loss"]) for h in history)
    assert (tmp_path / "dqn_ckpt" / D.CHECKPOINT_FILE).exists()

    served = S.rl_serve("rgl", "cpu", 2)
    assert S.rl_serve_gate("rgl", served, served) == []
    cfg = S.rl_env()
    net = make_network("sarl", device="cpu")
    states = crowd_sim.reset_device(cfg, 4, torch.Generator().manual_seed(1),
                                    "cpu")
    S.rl_collect_cross(net, cfg, dqn, states, ("cpu", "cpu"))
    collect = D.make_collect_step(net, cfg, dqn,
                                  D.build_action_space(cfg, dqn, "cpu"))
    buf = D.ReplayBuffer.create(64, 3, "cpu")
    for i in range(4):
        states, trans, _ = collect(states, 4 * i,
                                   torch.Generator().manual_seed(i))
        buf = D.buffer_add(buf, trans, 4)
    S.rl_train_cross(net, make_network("sarl", device="cpu", seed=2),
                     D.buffer_sample(buf, 16, torch.Generator()), dqn,
                     ("cpu", "cpu"))

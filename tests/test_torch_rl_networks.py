"""Parity of the port's SARL and RGL value networks
(sicnav_tpu_torch.rl.networks) and their conversion (convert.py) with the
JAX reference (sicnav_tpu.rl.networks).

- Forward at random Flax weights and at the two shipped checkpoints
  (``checkpoints/{sarl,rgl}_200k``, Orbax, against
  ``weights/{sarl,rgl}_200k.npz``), on (B, H) batches with padded human
  slots (max_humans 5, human_num 3): 1e-5 relative to the largest value.
- The MSE's gradients against ``jax.grad`` on the same padded batch:
  every tensor within 1e-5 of its largest entry, and finite (the masks'
  -1e9 fills and SARL's inf-filled min are differentiated). SARL's last
  attention bias shifts every score alike, which the softmax cancels: its
  gradient is rounding on both sides, held under 1e-6 of the largest
  gradient instead.
- ``convert.rl_flax_params`` inverts ``sarl_state_dict`` /
  ``rgl_state_dict`` exactly, and the committed ``.npz`` files regenerate
  bit for bit from the checkpoints (``scripts/convert_rl_torch.py``).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion.mid import load_checkpoint
from sicnav_tpu.rl import networks as N_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.rl import networks as N

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REL = 1e-5
# SARL's last attention bias shifts every score alike
SOFTMAX_SHIFTS = {"['attention']['Dense_2']['bias']"}
NETS = {"sarl": (N_ref.SARLNetwork, N.SARLNetwork, convert.sarl_state_dict),
        "rgl": (N_ref.RGLNetwork, N.RGLNetwork, convert.rgl_state_dict)}


def inputs(seed, B=6, H=5, n_real=3):
    """Robot states, human states and masks in the ranges the env gives
    (positions within 5 m, speeds within 1 m/s, radii 0.3), the last
    H - n_real slots padded with garbage."""
    rng = np.random.default_rng(seed)
    robot = np.concatenate(
        [rng.uniform(-4, 4, (B, 2)), rng.uniform(-1, 1, (B, 2)),
         np.full((B, 1), 0.3), rng.uniform(-4, 4, (B, 2)), np.ones((B, 1)),
         rng.uniform(-3, 3, (B, 1))], -1).astype(np.float32)
    humans = np.concatenate([rng.uniform(-4, 4, (B, H, 2)),
                             rng.uniform(-1, 1, (B, H, 2)),
                             np.full((B, H, 1), 0.3)], -1).astype(np.float32)
    humans[:, n_real:] = rng.uniform(-50, 50, humans[:, n_real:].shape)
    mask = np.zeros((B, H), bool)
    mask[:, :n_real] = True
    return robot, humans, mask


def ref_params(name, seed=0, H=5):
    ref_cls = NETS[name][0]
    return ref_cls().init(jax.random.PRNGKey(seed), jnp.zeros(9),
                          jnp.zeros((H, 5)), jnp.ones(H, bool))


def checkpoint_params(name):
    like = ref_params(name, H=3)
    return load_checkpoint(os.path.join(ROOT, "checkpoints", f"{name}_200k"),
                           like)


def port_net(name, params):
    _, cls, to_sd = NETS[name]
    net = cls(device="cpu")
    net.load_state_dict(to_sd(jax.tree.map(np.asarray, params)))
    return net


def _close_rel(got, want, rel=REL):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("name", ["sarl", "rgl"])
@pytest.mark.parametrize("weights", ["random", "checkpoint"])
def test_forward_with_padded_slots(name, weights):
    params = (ref_params(name, seed=3) if weights == "random"
              else checkpoint_params(name))
    net = port_net(name, params)
    ref = NETS[name][0]()
    robot, humans, mask = inputs(1)
    want = ref.apply(params, robot, humans, mask)
    with torch.no_grad():
        got = net(*map(torch.as_tensor, (robot, humans, mask)))
    assert got.shape == (6,)
    _close_rel(got.numpy(), want)
    # garbage in the padded slots does not move the value
    humans2 = humans.copy()
    humans2[:, 3:] = 7.0
    with torch.no_grad():
        got2 = net(*map(torch.as_tensor, (robot, humans2, mask)))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_mse_gradients_match_jax_grad(name):
    params = ref_params(name, seed=5)
    ref = NETS[name][0]()
    net = port_net(name, params)
    robot, humans, mask = inputs(2, B=8)
    target = np.random.default_rng(9).normal(0, 1, 8).astype(np.float32)

    def loss_fn(p):
        return jnp.mean((ref.apply(p, robot, humans, mask) - target) ** 2)

    loss_ref, g_ref = jax.value_and_grad(loss_fn)(params)
    v = net(*map(torch.as_tensor, (robot, humans, mask)))
    loss = torch.mean((v - torch.as_tensor(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=REL)
    grads = {k: p.grad for k, p in net.named_parameters()}
    got = convert.rl_flax_params(grads)["params"]
    want = jax.tree.map(np.asarray, g_ref)["params"]
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    scale = max(np.abs(w).max() for w in flat_want.values())
    for path, g in flat_got:
        assert np.isfinite(g).all(), path
        if jax.tree_util.keystr(path) in SOFTMAX_SHIFTS:
            # adds one constant to every score, which the softmax cancels:
            # its gradient is rounding on both sides
            for side in (g, flat_want[path]):
                assert np.abs(side).max() <= 1e-6 * scale, path
            continue
        _close_rel(g, flat_want[path])


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_state_dict_round_trip(name):
    params = jax.tree.map(np.asarray, ref_params(name, seed=1))
    sd = NETS[name][2](params)
    back = convert.rl_flax_params(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    net = NETS[name][1](device="cpu")
    assert set(net.state_dict()) == set(sd)
    for k, v in net.state_dict().items():
        assert v.shape == sd[k].shape, k


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_fresh_parameters_use_flax_initializers(name):
    """Zero biases, lecun-normal kernels (std sqrt(1/fan_in), cut at two
    standard deviations of the underlying normal) and, for RGL,
    normal(1/sqrt(X_dim)) graph weights; the same on every call with one
    seed."""
    a = NETS[name][1](device="cpu", seed=4)
    b = NETS[name][1](device="cpu", seed=4)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
        if k.endswith("bias"):
            assert not v.any(), k
        elif k.endswith("weight"):
            std = 1.0 / np.sqrt(v.shape[1])
            assert v.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6, k
        else:
            assert abs(v.std().item() * np.sqrt(32) - 1.0) < 0.2, k


def test_input_transformation_matches_reference():
    robot, humans, _ = inputs(4)
    want = N_ref.input_transformation(robot, humans)
    got = N.input_transformation(torch.as_tensor(robot),
                                 torch.as_tensor(humans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_configs_match_reference():
    assert dataclasses.asdict(N.SARLConfig()) == dataclasses.asdict(
        N_ref.SARLConfig())
    assert dataclasses.asdict(N.RGLConfig()) == dataclasses.asdict(
        N_ref.RGLConfig())


@pytest.mark.parametrize("name", ["sarl", "rgl"])
def test_converted_weights_regenerate(name):
    """scripts/convert_rl_torch.py, run on the repo's checkpoint, gives the
    committed file's arrays exactly, and the port loads them."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import convert_rl_torch
    fresh = convert_rl_torch.convert(name)
    path = os.path.join(ROOT, "weights", f"{name}_200k.npz")
    with np.load(path) as f:
        assert sorted(f.files) == sorted(fresh)
        for k in f.files:
            assert f[k].dtype == np.float32
            np.testing.assert_array_equal(f[k], fresh[k], err_msg=k)
    assert os.path.getsize(path) < 1 << 20
    NETS[name][1](device="cpu").load_state_dict(convert.load_npz(path))

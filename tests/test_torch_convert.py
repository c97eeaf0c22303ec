"""The port's parameters in the reference's layout (``convert.flax_params``)
and the port's ``.npz`` files (``convert.save_npz``).

- port -> Flax tree -> port is exact, and the tree has the reference's
  structure and shapes, leaf for leaf;
- the JAX model given the port's parameters samples what the port samples
  from the same start noise (1e-4, as ``tests/test_torch_jmid.py``);
- an ``.npz`` written by the port reads back exactly with
  ``load_npz`` and serves through ``sicnav_diffusion.make_policy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from tests.test_torch_jmid import _scene, _to_torch

torch.set_num_threads(2)


def port_model(cfg_kw, seed):
    m = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    M.init_parameters(m, torch.Generator().manual_seed(seed))
    return m


@pytest.mark.parametrize("cfg_kw", [
    dict(context_dim=32, enc_rnn_dim=16, tf_layer=1),
    dict(context_dim=48, enc_rnn_dim=8, tf_layer=2, n_heads=6)])
def test_round_trip_and_structure(cfg_kw):
    port = port_model(cfg_kw, 0)
    tree = convert.flax_params(port.state_dict(), cfg_kw.get("n_heads", 4))
    back = convert.jmid_state_dict(tree)
    sd = port.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype
        assert torch.equal(back[k], v), k
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    key = jax.random.PRNGKey(0)
    like = jax.eval_shape(lambda: ref.init(
        {"params": key, "dropout": key},
        jax.tree.map(jnp.asarray, _scene(0)), key))
    want = jax.tree_util.tree_structure(like)
    assert jax.tree_util.tree_structure(tree) == want
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_reference_samples_what_the_port_samples():
    cfg_kw = dict(context_dim=32, enc_rnn_dim=16, tf_layer=2)
    port = port_model(cfg_kw, 1)
    ref = MID_ref.JMIDModel(M_ref.ModelConfig(**cfg_kw), joint=True)
    params = jax.tree.map(jnp.asarray, convert.flax_params(port.state_dict()))
    batch = _scene(3)
    n, stride = 5, 10
    key = jax.random.PRNGKey(2)
    want = ref.apply(params, jax.tree.map(jnp.asarray, batch), key, n,
                     stride=stride, method=MID_ref.JMIDModel.sample)
    x_T = jax.random.normal(jax.random.split(key)[0],
                            (n * batch.hist.shape[0], 8, 2))
    got = port.sample(_to_torch(batch), n, x_T=torch.tensor(np.asarray(x_T)),
                      stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_npz_round_trip_serves(tmp_path):
    from sicnav_tpu_torch.diffusion import forecaster as FC
    from sicnav_tpu_torch.env import crowd_sim as CS
    from sicnav_tpu_torch.env.types import EnvConfig
    from sicnav_tpu_torch.mpc import sicnav_diffusion as SD

    cfg_kw = dict(context_dim=32, enc_rnn_dim=16, tf_layer=1)
    port = port_model(cfg_kw, 2)
    path = tmp_path / "w.npz"
    MID.save_checkpoint(str(path), port.state_dict())
    sd = convert.load_npz(str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k
    fresh = MID.JMIDModel(M.ModelConfig(**cfg_kw), device="cpu")
    fresh.load_state_dict(MID.load_checkpoint(str(path)), strict=True)
    cfg = EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                    human_num=3, max_humans=3, starts_moving=0,
                    robot_kinematics="unicycle")
    fcfg = FC.ForecasterConfig(num_samples=12, num_ret_samples=4,
                               ddim_stride=25, dt=cfg.dt)
    state = CS.reset_host(cfg, 0, device="cpu")
    fstate = FC.update_state_hists(FC.init_state(3, fcfg, device="cpu"),
                                   state, fcfg)
    x_T = torch.randn((12 * 3, 8, 2), generator=torch.Generator().manual_seed(0))
    a = FC.predict_ret_best(port, fstate, state, fcfg, x_T=x_T)
    b = FC.predict_ret_best(fresh, fstate, state, fcfg, x_T=x_T)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ocp, policy = SD.make_policy(cfg, fresh, fcfg=fcfg, device="cpu")
    assert callable(policy)

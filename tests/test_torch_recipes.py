"""The port's training recipes (``sicnav_tpu_torch.diffusion.recipes``)
field by field against the reference's, and one iMID train step at a
recipe's settings against the reference's ``train_step``.

The recipes are plain values: every field equal. The train step runs on a
stacked batch of ETH-format scenes from the port's synthesizer with the
reference's per-scene t and eps injected (dropout 0): the loss within
1e-5, the parameters after the clip and the Adam update within 1e-5
(float32 sums in other orders through the encoder, the denoiser and their
backward passes). The attention key biases are held apart: a key bias
adds one constant to each query's logits, which the softmax cancels, so
its gradient is rounding alone and Adam steps it by up to lr on that
rounding's sign.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import recipes as R_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import data as D
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import recipes as R
from tests.test_torch_imid import eth_examples, port_model, reference

torch.set_num_threads(2)


def test_recipe_names():
    assert list(R.RECIPES) == list(R_ref.RECIPES)
    assert len(R.RECIPES) == 13
    assert sum(not r.joint for r in R.RECIPES.values()) == 7


@pytest.mark.parametrize("name", sorted(R_ref.RECIPES))
def test_recipe_fields(name):
    got, want = R.get_recipe(name), R_ref.get_recipe(name)
    for f in dataclasses.fields(R_ref.Recipe):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
        else:
            assert g == w, f.name
    assert got.model.horizon == got.horizon
    assert got.model.history_len == got.history_len


def test_unknown_recipe():
    with pytest.raises(KeyError, match="available"):
        R.get_recipe("ddim_p3_bs256_lr001_nowhere")


SMALL = dict(context_dim=16, enc_rnn_dim=8, tf_layer=1, n_heads=2,
             dropout=0.0, rnn_dropout=0.0)


def test_imid_train_step_matches_reference():
    """The ETH iMID recipe's optimizer (lr 1e-3, clip 1.0) over a stacked
    batch of four ETH-format scenes at small widths."""
    recipe = R.get_recipe("ddim_p3_bs256_lr001_eth")
    ex = eth_examples()[:4]
    batch = D.stack_batches(ex)
    ref, params = reference(SMALL, ex[0])
    tc = dataclasses.replace(recipe.train, batch_size=4)
    sched = optax.exponential_decay(tc.lr, 1, tc.lr_decay, staircase=True)
    tx = optax.chain(optax.clip_by_global_norm(tc.grad_clip),
                     optax.adam(sched))
    key = jax.random.PRNGKey(5)
    jb = jax.tree.map(jnp.asarray, batch)
    new_params, _, loss = MID_ref.train_step(ref, tx, params,
                                             tx.init(params), jb, key)
    # the reference's draws: one key per scene, split into t and eps
    B, A, T = batch.fut_vel.shape[:3]
    ts, eps = [], []
    for k in jax.random.split(key, B):
        k_t, k_e = jax.random.split(k)
        ts.append(np.asarray(jax.random.randint(k_t, (A,), 1, 101)))
        eps.append(np.asarray(jax.random.normal(k_e, (A, T, 2))))
    port = port_model(SMALL, convert.jmid_state_dict(params))
    state = MID.make_train_state(port, tc, 1, init=False)
    got = MID.train_step(port, state, batch.to_tensors("cpu"),
                         t=torch.as_tensor(np.stack(ts)).long(),
                         eps=torch.as_tensor(np.stack(eps)))
    np.testing.assert_allclose(float(got), float(loss), rtol=0, atol=1e-5)
    want = convert.jmid_state_dict(jax.tree.map(np.asarray, new_params))
    sd = port.state_dict()
    for k, w in want.items():
        if k.endswith("attn.key.bias"):
            continue
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)

"""Parity of the port's JMID training (``diffusion.diffusion_loss``,
``mid.JMIDModel.forward``, ``make_train_state``, ``train_step``, ``fit``)
with the JAX reference, at small widths with dropout 0.

The scenes are the port's own sim examples (device resets, the ORCA robot,
``build_examples``) with absent agents and partly observed futures, so the
loss's masks matter. Both sides get the same parameters (``convert``) and
the diffusion steps and noise JAX draws from the same keys.

Tolerances: the loss 1e-5 (float32 sums in other orders); each gradient
tensor within 1e-4 of its largest entry (the backward pass sums more
terms); the parameters after three Adam steps 1e-5 (each update is at
most about lr in size, and rounding moves it far less). The attention key
biases are left out of the last two: they do not enter the function, their
gradient is zero (held under 1e-8 on both sides) and Adam steps each by up
to lr on the sign of rounding.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sicnav_tpu.diffusion import mid as MID_ref
from sicnav_tpu.diffusion import models as M_ref
from sicnav_tpu_torch import convert
from sicnav_tpu_torch.diffusion import data as D
from sicnav_tpu_torch.diffusion import diffusion as DF
from sicnav_tpu_torch.diffusion import mid as MID
from sicnav_tpu_torch.diffusion import models as M
from sicnav_tpu_torch.env import crowd_sim as CS
from sicnav_tpu_torch.env import rollout as R
from sicnav_tpu_torch.env.types import EnvConfig
from sicnav_tpu_torch.policies.orca_robot import orca_robot_action

torch.set_num_threads(2)
SMALL = dict(context_dim=32, enc_rnn_dim=16, tf_layer=1, n_heads=4)
NO_DROPOUT = dict(SMALL, dropout=0.0, rnn_dropout=0.0)


def sim_examples(n_scenes=2, steps=24, human_num=3, max_humans=5, seed=0):
    """Port sim examples: hallway resets with absent slots, the ORCA
    robot, then the scenes sliced as train_jmid slices them."""
    cfg = EnvConfig(scenario="hallway_bottleneck", human_policy="orca_plus",
                    human_num=human_num, max_humans=max_humans,
                    starts_moving=0, robot_kinematics="holonomic")
    gen = torch.Generator().manual_seed(seed)
    states = CS.reset_device(cfg, n_scenes, gen, device="cpu")
    _, _, traj = R.batch_rollout(states, lambda s: orca_robot_action(s, cfg),
                                 cfg, steps)
    traj = CS.tree_map(lambda x: x.numpy(), traj)
    out = []
    for b in range(n_scenes):
        pos, valid = D.scenes_from_env_rollout(
            CS.tree_map(lambda x: x[b], traj))
        out += D.build_examples(pos, valid, cfg.dt, stride=4)
    return out


def masked_batch(n=4):
    """A stacked batch of n scenes; one agent of each loses its last future
    steps, one scene loses an agent's history frames."""
    ex = sim_examples()[:n]
    b = D.stack_batches(ex)
    fut_mask = b.fut_mask.copy()
    fut_mask[:, 1, 5:] = False
    hist_mask = b.hist_mask.copy()
    hist_mask[0, 0, :2] = False
    hist = np.where(hist_mask[..., None], b.hist, 0.0).astype(np.float32)
    return b._replace(fut_mask=fut_mask, hist_mask=hist_mask, hist=hist)


def _one(batch, i):
    return D.SceneBatch(*[None if x is None else x[i] for x in batch])


def ref_model():
    return MID_ref.JMIDModel(M_ref.ModelConfig(**NO_DROPOUT), joint=True)


def ref_params(batch, seed=0):
    key = jax.random.PRNGKey(seed)
    return jax.jit(ref_model().init)({"params": key, "dropout": key},
                                     jax.tree.map(jnp.asarray, _one(batch, 0)),
                                     key)


def port_model(params, cfg_kw=NO_DROPOUT):
    m = MID.JMIDModel(M.ModelConfig(**cfg_kw), joint=True, device="cpu")
    m.load_state_dict(convert.jmid_state_dict(jax.tree.map(np.asarray,
                                                           params)))
    return m


def jax_noise(key, A, T=8, num_steps=100):
    """The t (A,) and eps (A, T, 2) the reference's loss draws from key."""
    k_t, k_e = jax.random.split(key)
    t = jax.random.randint(k_t, (A,), 1, num_steps + 1)
    eps = jax.random.normal(k_e, (A, T, 2), jnp.float32)
    return np.asarray(t), np.asarray(eps)


def batch_noise(key, B, A):
    """train_step's per-scene keys and their noise, stacked."""
    per = [jax_noise(k, A) for k in jax.random.split(key, B)]
    return (torch.as_tensor(np.stack([p[0] for p in per])).long(),
            torch.as_tensor(np.stack([p[1] for p in per])))


def tree_close(got, want, rel=None, atol=None, path=""):
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            tree_close(g, w, rel, atol, f"{path}/{k}")
            continue
        w = np.asarray(w)
        tol = atol if rel is None else rel * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=tol,
                                   err_msg=f"{path}/{k}")


def key_biases(tree):
    den = tree["params"]["denoiser"]
    return [np.asarray(den[k]["MultiHeadDotProductAttention_0"]["key"]["bias"])
            for k in den if k.startswith("tf_")]


def without_key_bias(tree):
    """The tree without the attention key biases. A key bias adds one
    constant to each query's logits, which the softmax cancels: its
    gradient is zero in exact arithmetic and rounding alone on both sides,
    and Adam turns that rounding into steps of up to lr in either
    direction. It does not enter the model's function."""
    tree = jax.tree.map(lambda x: x, tree)
    den = tree["params"]["denoiser"]
    for k in den:
        if k.startswith("tf_"):
            del den[k]["MultiHeadDotProductAttention_0"]["key"]["bias"]
    return tree


def test_train_config_defaults_match():
    from sicnav_tpu.diffusion.mid import TrainConfig as Ref
    assert dataclasses.asdict(MID.TrainConfig()) == dataclasses.asdict(Ref())


def test_nfe_count():
    from sicnav_tpu.diffusion.diffusion import nfe_count
    for n, s in ((100, 2), (100, 1), (100, 3), (50, 7)):
        assert DF.nfe_count(n, s) == nfe_count(n, s)


def test_diffusion_loss_one_scene():
    batch = masked_batch(1)
    params = ref_params(batch)
    one = _one(batch, 0)
    key = jax.random.PRNGKey(5)
    want = ref_model().apply(params, jax.tree.map(jnp.asarray, one), key,
                             rngs={"dropout": key})
    t, eps = jax_noise(key, one.hist.shape[0])
    got = port_model(params)(one.to_tensors("cpu"), t=torch.tensor(t).long(),
                             eps=torch.tensor(eps))
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)


def test_loss_and_gradients_over_a_batch():
    """The mean over scenes and its gradient, mapped through convert."""
    batch = masked_batch(4)
    params = ref_params(batch)
    key = jax.random.PRNGKey(11)
    B, A = batch.hist.shape[:2]
    keys = jax.random.split(key, B)
    model = ref_model()
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        return jnp.mean(jax.vmap(lambda b, k: model.apply(
            p, b, k, rngs={"dropout": k}))(jb, keys))

    want, g_ref = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = port_model(params)
    t, eps = batch_noise(key, B, A)
    loss = port(batch.to_tensors("cpu"), t=t, eps=eps).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=0, atol=1e-5)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = convert.flax_params(grads)
    want = jax.tree.map(np.asarray, g_ref)
    for side in (got, want):
        assert max(np.abs(b).max() for b in key_biases(side)) < 1e-8
    tree_close(without_key_bias(got), without_key_bias(want), rel=1e-4)


def test_three_train_steps_match_optax():
    """Clip, Adam and a decay after every step (steps_per_epoch = 1); the
    clip must bind on the first step."""
    batch = masked_batch(4)
    B, A = batch.hist.shape[:2]
    tc_ref = MID_ref.TrainConfig(lr=1e-3, lr_decay=0.5, grad_clip=0.5, seed=3)
    model = ref_model()
    params, tx, opt_state = MID_ref.make_train_state(
        model, _one(batch, 0), tc_ref, steps_per_epoch=1)
    port = port_model(params)
    tc = MID.TrainConfig(**dataclasses.asdict(tc_ref))
    state = MID.make_train_state(port, tc, steps_per_epoch=1, init=False)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = batch.to_tensors("cpu")
    key = jax.random.PRNGKey(21)
    norms = []
    for _ in range(3):
        key, k = jax.random.split(key)
        params, opt_state, loss_ref = MID_ref.train_step(
            model, tx, params, opt_state, jb, k)
        t, eps = batch_noise(k, B, A)
        clip = MID.clip_by_global_norm_
        MID.clip_by_global_norm_ = lambda ps, m: norms.append(
            float(clip(ps, m))) or None
        try:
            loss = MID.train_step(port, state, tb, t=t, eps=eps)
        finally:
            MID.clip_by_global_norm_ = clip
        np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=0,
                                   atol=1e-5)
        tree_close(without_key_bias(convert.flax_params(port.state_dict())),
                   without_key_bias(jax.tree.map(np.asarray, params)),
                   atol=1e-5)
    assert norms[0] > tc.grad_clip, norms
    assert not port.training


def test_make_train_state_draws_flax_initializers():
    """Parameters drawn anew from the seed: Flax's initializers' scales
    (lecun-normal kernels, orthogonal recurrent kernels, zero biases), the
    same on every call with one seed."""
    batch = masked_batch(1)
    params = jax.tree.map(np.asarray, ref_params(batch))
    tc = MID.TrainConfig(seed=4)
    a = port_model(params)
    MID.make_train_state(a, tc, 1)
    b = port_model(params)
    MID.make_train_state(b, tc, 1)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    got = convert.flax_params(a.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in flat_ref:
        g = flat_got[path]
        assert g.shape == w.shape, path
        if np.all(w == 0) or np.all(w == 1):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        elif w.size > 500:
            # the draws differ; their scale must not
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.15,
                                       err_msg=str(path))
    w_h = a.encoder.history_lstm.w_h.weight.detach()
    for gate in w_h.split(a.cfg.enc_rnn_dim):
        torch.testing.assert_close(gate @ gate.T, torch.eye(gate.shape[0]),
                                   rtol=0, atol=1e-5)


def test_dropout_is_live_in_train_mode_only():
    batch = masked_batch(2)
    params = ref_params(batch)
    model = port_model(params, SMALL)      # the default dropout rates
    tb = batch.to_tensors("cpu")
    B, A = batch.hist.shape[:2]
    t, eps = batch_noise(jax.random.PRNGKey(0), B, A)

    def loss(seed):
        return model(tb, torch.Generator().manual_seed(seed), t, eps)

    model.eval()
    assert torch.equal(loss(0), loss(1))
    model.train()
    assert not torch.equal(loss(0), loss(1))
    assert torch.equal(loss(2), loss(2))
    # inference has no dropout in either mode
    x_T = torch.randn((3 * A, 8, 2), generator=torch.Generator().manual_seed(0))
    one = _one(batch, 0).to_tensors("cpu")
    s_train = model.sample(one, 3, x_T=x_T, stride=20)
    assert model.training
    model.eval()
    assert torch.equal(s_train, model.sample(one, 3, x_T=x_T, stride=20))


def test_dropout_rates_and_scaling():
    x = torch.ones(200_000)
    y = M.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert M.dropout(x, 0.0) is x


def _scripted_fit(monkeypatch, tmp_path, ades, patience):
    batch = masked_batch(4)
    model = port_model(ref_params(batch), SMALL)
    script = iter(ades)
    snaps, saves = [], []

    def fake_eval(model, b, n, generator=None, stride=2):
        snaps.append({k: v.clone() for k, v in model.state_dict().items()})
        a = torch.full(b.agent_mask.shape[:-1], next(script))
        return a, a, a, a

    save = MID.save_checkpoint
    monkeypatch.setattr(MID, "eval_scene", fake_eval)
    monkeypatch.setattr(MID, "save_checkpoint",
                        lambda p, sd: saves.append(len(snaps)) or save(p, sd))
    tc = MID.TrainConfig(epochs=len(ades), early_stop_patience=patience,
                         lr=1e-3)
    ckpt = tmp_path / "jmid.npz"
    best, hist = MID.fit(model, [batch, batch], [_one(batch, 0)], tc,
                         checkpoint_path=str(ckpt), log_dir=str(tmp_path))
    return model, best, hist, snaps, saves, ckpt


def test_fit_early_stop_best_params_and_checkpoints(monkeypatch, tmp_path):
    ades = [3.0, 2.0, 2.5, 1.5, 1.75, 1.875, 1.0]   # exact in float32
    model, best, hist, snaps, saves, ckpt = _scripted_fit(
        monkeypatch, tmp_path, ades, patience=2)
    # epochs 4 and 5 do not improve on epoch 3: stopped before epoch 6
    assert [h["val_ade"] for h in hist] == ades[:6]
    assert len(snaps) == 6
    # a checkpoint after each improvement (epochs 0, 1, 3) and at the end
    assert saves == [1, 2, 4, 6]
    for k, v in model.state_dict().items():
        assert torch.equal(v, snaps[3][k]), k
        assert torch.equal(best[k], snaps[3][k]), k
    assert not torch.equal(snaps[3]["denoiser.linear.layer.weight"],
                           snaps[5]["denoiser.linear.layer.weight"])
    on_disk = MID.load_checkpoint(str(ckpt))
    for k, v in on_disk.items():
        assert torch.equal(v, snaps[3][k]), k
    lines = [json.loads(x) for x in
             (tmp_path / "jmid.jsonl").read_text().splitlines()]
    assert [x["val_ade"] for x in lines] == ades[:6]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_fit_runs_every_epoch_while_improving(monkeypatch, tmp_path):
    ades = [3.0, 2.0, 1.0]
    model, best, hist, snaps, saves, _ = _scripted_fit(
        monkeypatch, tmp_path, ades, patience=1)
    assert len(hist) == 3 and saves == [1, 2, 3, 3]
    for k, v in model.state_dict().items():
        assert torch.equal(v, snaps[2][k]), k


def test_fit_trains_and_validates():
    """An unscripted run: finite losses and val ADEs, the model left
    holding the returned best parameters."""
    ex = sim_examples(n_scenes=4)
    batches = [D.stack_batches(ex[i:i + 4]) for i in range(0, 12, 4)]
    model = MID.JMIDModel(M.ModelConfig(**SMALL), device="cpu")
    tc = MID.TrainConfig(epochs=2, batch_size=4, eval_samples=4,
                         eval_stride=20)
    best, hist = MID.fit(model, batches[1:], batches[:1], tc)
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_ade"])
               for h in hist)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k

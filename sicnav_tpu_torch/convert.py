"""JMID / iMID, SARL and RGL parameters between the reference's Flax
layout and the port's modules, and the port's ``.npz`` weight files.

``jmid_state_dict`` takes the reference's JMID parameter tree as nested
dicts of numpy arrays (the ``params`` collection of
``sicnav_tpu.diffusion.mid.JMIDModel``, with or without the top
``"params"`` key) and returns a ``state_dict`` for
``sicnav_tpu_torch.diffusion.mid.JMIDModel``. It reads numpy only, so the
tree can come from any reader of the reference's checkpoints.
``flax_params`` is its inverse: the port's ``state_dict`` as the
reference's ``{"params": ...}`` tree of numpy arrays, which the reference's
``model.apply`` takes (so the reference can score weights the port
trained, and tests can map the port's gradients onto the reference's).
``save_npz`` / ``load_npz`` write and read any state_dict in the port's
layout.

``sarl_state_dict`` and ``rgl_state_dict`` do the same for the RL value
networks (``sicnav_tpu.rl.networks``): every ``MLP`` submodule's
``Dense_i`` becomes ``<mlp>.layers.<i>``, and RGL's raw ``w_a``, ``w1``
and ``w2`` are kept as they are (they multiply from the right in both
packages). ``rl_flax_params`` is their inverse.

Layouts handled:
- ``Dense`` kernels are (in, out); ``nn.Linear`` weights are (out, in).
- Attention ``query/key/value`` kernels are (d, heads, head_dim) with
  (heads, head_dim) biases; ``out`` is (heads, head_dim, d).
- ``OptimizedLSTMCell`` keeps one Dense per gate: ``ii/if/ig/io`` without
  bias, ``hi/hf/hg/ho`` with bias, gate order (i, f, g, o). The port
  concatenates them along the output axis.
- ``LayerNorm`` keeps ``scale`` and ``bias`` (the port's LayerNorm uses
  Flax's epsilon 1e-6).
- ``Embed`` keeps ``embedding`` (num, width), as ``nn.Embedding.weight``.
- Denoiser submodules: ``tf_i`` -> ``tf.i``, TrajNet's ``csl_i`` ->
  ``csl.i``, the flat MLPs' ``mlp/layer_i`` -> ``mlp.layers.i``; every
  other ConcatSquash or Dense keeps its name.
"""

from __future__ import annotations

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _dense(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _lstm(sd, prefix, p):
    cell = p["Scan_MaskedLSTMCell_0"]["OptimizedLSTMCell_0"]
    w_i = np.concatenate([cell["i" + g]["kernel"] for g in _GATES], axis=-1)
    w_h = np.concatenate([cell["h" + g]["kernel"] for g in _GATES], axis=-1)
    b_h = np.concatenate([cell["h" + g]["bias"] for g in _GATES], axis=-1)
    sd[prefix + ".w_i.weight"] = _t(w_i.T)
    sd[prefix + ".w_h.weight"] = _t(w_h.T)
    sd[prefix + ".w_h.bias"] = _t(b_h)


def _attention(sd, prefix, p):
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])                 # (d, heads, hd)
        sd[f"{prefix}.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
        sd[f"{prefix}.{name}.bias"] = _t(np.asarray(p[name]["bias"]).reshape(-1))
    k = np.asarray(p["out"]["kernel"])                    # (heads, hd, d)
    sd[prefix + ".out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    sd[prefix + ".out.bias"] = _t(p["out"]["bias"])


def _layer_norm(sd, prefix, p):
    sd[prefix + ".scale"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _concat_squash(sd, prefix, p):
    for name in ("layer", "hyper_gate", "hyper_bias"):
        _dense(sd, f"{prefix}.{name}", p[name])


def _transformer_layer(sd, prefix, p):
    _attention(sd, prefix + ".attn", p["MultiHeadDotProductAttention_0"])
    _layer_norm(sd, prefix + ".norm0", p["LayerNorm_0"])
    _dense(sd, prefix + ".ff0", p["Dense_0"])
    _dense(sd, prefix + ".ff1", p["Dense_1"])
    _layer_norm(sd, prefix + ".norm1", p["LayerNorm_1"])


def _encoder(sd, enc, prefix="encoder"):
    _lstm(sd, f"{prefix}.history_lstm", enc["history_lstm"])
    _lstm(sd, f"{prefix}.edge_lstm", enc["edge_lstm"])
    att = enc["edge_attention"]
    for i, name in enumerate(("w1", "w2", "v")):
        _dense(sd, f"{prefix}.edge_attention.{name}", att[f"Dense_{i}"])
    for name in ("class_embed", "edge_class_embed"):
        if name in enc:
            sd[f"{prefix}.{name}.weight"] = _t(enc[name]["embedding"])
    if "class_film" in enc:
        _dense(sd, f"{prefix}.class_film", enc["class_film"])


def cvae_state_dict(params) -> dict:
    """Reference ``trajectron.CVAETrajectron`` parameter tree (numpy) ->
    the port's state_dict: the shared encoder, the future LSTM, the dense
    heads and the GRU cell (Flax's ``in`` Dense is the port's ``in_``)."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, p in params.items():
        if name == "encoder":
            _encoder(sd, p)
        elif name == "node_future_encoder":
            _lstm(sd, name, p)
        elif name == "decoder_rnn_cell":
            for gate, q in p.items():
                _dense(sd, f"{name}.{'in_' if gate == 'in' else gate}", q)
        else:
            _dense(sd, name, p)
    return sd


def map_encoder_state_dict(params) -> dict:
    """Reference ``trajectron.CNNMapEncoder`` parameters -> the port's:
    ``Conv_i`` kernels (kh, kw, in, out) become ``convs.i`` weights
    (out, in, kh, kw); ``Dense_0`` becomes ``dense``."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, p in params.items():
        if name.startswith("Conv_"):
            pre = f"convs.{name.split('_')[1]}"
            sd[pre + ".weight"] = _t(np.asarray(p["kernel"]).transpose(
                3, 2, 0, 1))
            sd[pre + ".bias"] = _t(p["bias"])
        else:
            _dense(sd, "dense", p)
    return sd


def jmid_state_dict(params) -> dict:
    """Reference JMID / iMID parameter tree (numpy) -> the port's
    state_dict, for every denoiser of ``models.DIFFNETS`` and for
    class-conditioned encoders."""
    if "params" in params:
        params = params["params"]
    sd = {}
    _encoder(sd, params["encoder"])
    for name, p in params["denoiser"].items():
        if name.startswith("tf_"):
            _transformer_layer(sd, f"denoiser.tf.{name[3:]}", p)
        elif name.startswith("csl_"):
            _concat_squash(sd, f"denoiser.csl.{name[4:]}", p)
        elif name == "mlp":
            for layer, q in p.items():
                _dense(sd, "denoiser.mlp." + (
                    "out" if layer == "out" else
                    f"layers.{layer.split('_')[1]}"), q)
        elif "hyper_gate" in p:
            _concat_squash(sd, f"denoiser.{name}", p)
        else:
            _dense(sd, f"denoiser.{name}", p)
    return sd


def load_npz(path) -> dict:
    """A state_dict of the port from an ``.npz`` of float32 arrays keyed by
    parameter name, as ``scripts/convert_jmid_torch.py`` and
    ``scripts/convert_rl_torch.py`` write them (numpy only: no JAX, Flax or
    Orbax)."""
    with np.load(path) as f:
        return {k: _t(f[k]) for k in f.files}


def _rl_state_dict(params, mlps, raw=()) -> dict:
    if "params" in params:
        params = params["params"]
    sd = {}
    for name in mlps:
        for dense, p in params[name].items():
            _dense(sd, f"{name}.layers.{int(dense.split('_')[1])}", p)
    for name in raw:
        if name in params:
            sd[name] = _t(params[name])
    return sd


def sarl_state_dict(params) -> dict:
    """Reference SARLNetwork parameter tree (numpy) -> the port's
    state_dict."""
    return _rl_state_dict(params, ("mlp1", "mlp2", "attention", "mlp3"))


def rgl_state_dict(params) -> dict:
    """Reference RGLNetwork parameter tree (numpy) -> the port's
    state_dict."""
    return _rl_state_dict(params, ("w_r", "w_h", "value_net"),
                          ("w_a", "w1", "w2"))


def rl_flax_params(state_dict) -> dict:
    """The port's SARL or RGL state_dict -> the reference's variables
    ``{"params": tree}`` as nested dicts of numpy arrays."""
    tree = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if len(parts) == 1:
            tree[k] = _np(v)
            continue
        mlp, _, i, kind = parts
        dense = tree.setdefault(mlp, {}).setdefault(f"Dense_{i}", {})
        dense["kernel" if kind == "weight" else "bias"] = (
            _np(v).T if kind == "weight" else _np(v))
    return {"params": tree}


def _np(x):
    return x.detach().cpu().numpy().astype(np.float32)


def _dense_tree(sd, prefix):
    p = {"kernel": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["bias"] = _np(sd[prefix + ".bias"])
    return p


def _lstm_tree(sd, prefix):
    w_i = _np(sd[prefix + ".w_i.weight"]).T           # (in, 4H)
    w_h = _np(sd[prefix + ".w_h.weight"]).T           # (H, 4H)
    b_h = _np(sd[prefix + ".w_h.bias"])
    cell = {}
    for k, g in enumerate(_GATES):
        H = w_h.shape[0]
        cols = slice(k * H, (k + 1) * H)
        cell["i" + g] = {"kernel": w_i[:, cols]}
        cell["h" + g] = {"kernel": w_h[:, cols], "bias": b_h[cols]}
    return {"Scan_MaskedLSTMCell_0": {"OptimizedLSTMCell_0": cell}}


def _attention_tree(sd, prefix, n_heads):
    p = {}
    for name in ("query", "key", "value"):
        w = _np(sd[f"{prefix}.{name}.weight"]).T          # (d, heads*hd)
        d = w.shape[0]
        p[name] = {"kernel": w.reshape(d, n_heads, -1),
                   "bias": _np(sd[f"{prefix}.{name}.bias"]).reshape(
                       n_heads, -1)}
    w = _np(sd[prefix + ".out.weight"]).T                 # (heads*hd, d)
    p["out"] = {"kernel": w.reshape(n_heads, -1, w.shape[-1]),
                "bias": _np(sd[prefix + ".out.bias"])}
    return p


def flax_params(state_dict, n_heads: int = 4) -> dict:
    """The port's JMID / iMID state_dict -> the reference's variables
    ``{"params": tree}`` as nested dicts of numpy arrays. ``n_heads`` is
    ``ModelConfig.n_heads``: the reference keeps the heads as an axis of
    the attention kernels (``TransformerLinear`` has 2 whatever the
    configuration)."""
    sd = state_dict
    att = {f"Dense_{i}": _dense_tree(sd, f"encoder.edge_attention.{name}")
           for i, name in enumerate(("w1", "w2", "v"))}
    enc = {"history_lstm": _lstm_tree(sd, "encoder.history_lstm"),
           "edge_lstm": _lstm_tree(sd, "encoder.edge_lstm"),
           "edge_attention": att}
    for name in ("class_embed", "edge_class_embed"):
        if f"encoder.{name}.weight" in sd:
            enc[name] = {"embedding": _np(sd[f"encoder.{name}.weight"])}
    if "encoder.class_film.weight" in sd:
        enc["class_film"] = _dense_tree(sd, "encoder.class_film")

    if "denoiser.ctx_up.weight" in sd:          # TransformerLinear
        n_heads = 2
    den = {}
    for key in sd:
        if not key.startswith("denoiser."):
            continue
        parts = key.split(".")[1:-1]            # module path, no leaf
        if parts[0] == "tf":
            name = f"tf_{parts[1]}"
            if name not in den:
                pre = f"denoiser.tf.{parts[1]}"
                den[name] = {
                    "MultiHeadDotProductAttention_0": _attention_tree(
                        sd, pre + ".attn", n_heads),
                    "LayerNorm_0": {"scale": _np(sd[pre + ".norm0.scale"]),
                                    "bias": _np(sd[pre + ".norm0.bias"])},
                    "Dense_0": _dense_tree(sd, pre + ".ff0"),
                    "Dense_1": _dense_tree(sd, pre + ".ff1"),
                    "LayerNorm_1": {"scale": _np(sd[pre + ".norm1.scale"]),
                                    "bias": _np(sd[pre + ".norm1.bias"])},
                }
        elif parts[0] == "mlp":
            layer = "out" if parts[1] == "out" else f"layer_{parts[2]}"
            den.setdefault("mlp", {})[layer] = _dense_tree(
                sd, "denoiser." + ".".join(parts))
        elif parts[-1] in ("layer", "hyper_gate", "hyper_bias"):
            name = f"csl_{parts[1]}" if parts[0] == "csl" else parts[0]
            den.setdefault(name, {})[parts[-1]] = _dense_tree(
                sd, "denoiser." + ".".join(parts))
        else:
            den[parts[0]] = _dense_tree(sd, f"denoiser.{parts[0]}")
    return {"params": {"encoder": enc, "denoiser": den}}


def save_npz(path, state_dict):
    """Write a state_dict as one ``.npz`` of float32 arrays keyed by
    parameter name, the file ``load_npz`` reads."""
    np.savez(path, **{k: _np(v) for k, v in state_dict.items()})

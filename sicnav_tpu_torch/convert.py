"""JMID, SARL and RGL parameters between the reference's Flax layout and
the port's modules, and the port's ``.npz`` weight files.

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


def jmid_state_dict(params) -> dict:
    """Reference JMID parameter tree (numpy) -> the port's state_dict."""
    if "params" in params:
        params = params["params"]
    sd = {}
    enc = params["encoder"]
    _lstm(sd, "encoder.history_lstm", enc["history_lstm"])
    _lstm(sd, "encoder.edge_lstm", enc["edge_lstm"])
    att = enc["edge_attention"]
    for i, name in enumerate(("w1", "w2", "v")):
        _dense(sd, f"encoder.edge_attention.{name}", att[f"Dense_{i}"])

    den = params["denoiser"]
    for name in ("concat1", "concat3", "concat4", "linear"):
        _concat_squash(sd, f"denoiser.{name}", den[name])
    n_layers = sum(1 for k in den if k.startswith("tf_"))
    for i in range(n_layers):
        p = den[f"tf_{i}"]
        pre = f"denoiser.tf.{i}"
        _attention(sd, pre + ".attn", p["MultiHeadDotProductAttention_0"])
        _layer_norm(sd, pre + ".norm0", p["LayerNorm_0"])
        _dense(sd, pre + ".ff0", p["Dense_0"])
        _dense(sd, pre + ".ff1", p["Dense_1"])
        _layer_norm(sd, pre + ".norm1", p["LayerNorm_1"])
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
    """The port's JMID state_dict -> the reference's variables
    ``{"params": tree}`` as nested dicts of numpy arrays. ``n_heads`` is
    ``ModelConfig.n_heads``: the reference keeps the heads as an axis of
    the attention kernels."""
    sd = state_dict
    att = {f"Dense_{i}": _dense_tree(sd, f"encoder.edge_attention.{name}")
           for i, name in enumerate(("w1", "w2", "v"))}
    enc = {"history_lstm": _lstm_tree(sd, "encoder.history_lstm"),
           "edge_lstm": _lstm_tree(sd, "encoder.edge_lstm"),
           "edge_attention": att}
    den = {name: {part: _dense_tree(sd, f"denoiser.{name}.{part}")
                  for part in ("layer", "hyper_gate", "hyper_bias")}
           for name in ("concat1", "concat3", "concat4", "linear")}
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("denoiser.tf.")})
    for i in range(n_layers):
        pre = f"denoiser.tf.{i}"
        den[f"tf_{i}"] = {
            "MultiHeadDotProductAttention_0": _attention_tree(
                sd, pre + ".attn", n_heads),
            "LayerNorm_0": {"scale": _np(sd[pre + ".norm0.scale"]),
                            "bias": _np(sd[pre + ".norm0.bias"])},
            "Dense_0": _dense_tree(sd, pre + ".ff0"),
            "Dense_1": _dense_tree(sd, pre + ".ff1"),
            "LayerNorm_1": {"scale": _np(sd[pre + ".norm1.scale"]),
                            "bias": _np(sd[pre + ".norm1.bias"])},
        }
    return {"params": {"encoder": enc, "denoiser": den}}


def save_npz(path, state_dict):
    """Write a state_dict as one ``.npz`` of float32 arrays keyed by
    parameter name, the file ``load_npz`` reads."""
    np.savez(path, **{k: _np(v) for k, v in state_dict.items()})

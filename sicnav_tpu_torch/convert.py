"""JMID parameters from the reference's Flax layout to the port's modules.

``jmid_state_dict`` takes the reference's JMID parameter tree as nested
dicts of numpy arrays (the ``params`` collection of
``sicnav_tpu.diffusion.mid.JMIDModel``, with or without the top
``"params"`` key) and returns a ``state_dict`` for
``sicnav_tpu_torch.diffusion.mid.JMIDModel``. It reads numpy only, so the
tree can come from any reader of the reference's checkpoints.

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


def load_jmid_npz(path) -> dict:
    """The port's JMID state_dict from an ``.npz`` written by
    ``scripts/convert_jmid_torch.py`` (numpy only: no JAX, Flax or Orbax)."""
    with np.load(path) as f:
        return {k: _t(f[k]) for k in f.files}

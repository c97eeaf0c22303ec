#!/usr/bin/env python3
"""Write a trained JMID / iMID predictor in the PyTorch port's layout.

    python scripts/convert_jmid_torch.py
        [--name jmid_hallway|imid_eth_proof|jmid_mc_man_nod]
        [--checkpoint checkpoints/<name>] [--out weights/<name>.npz]

Reads the Orbax checkpoint with the JAX package's own reader
(``sicnav_tpu.diffusion.mid.load_checkpoint``) at the checkpoint's widths
(``MODELS``: the hallway JMID at ``ModelConfig(context_dim=128,
tf_layer=2)``, the ETH iMID at ``context_dim=256, tf_layer=3``, its
recipe's, and the sim JMID ``jmid_mc_man_nod`` at the published
``ddim_jp_sim.yaml`` widths, ``context_dim=256, tf_layer=3``, one node
type, trained on 5 ORCA humans crossing a circle), maps the Flax tree through
``sicnav_tpu_torch.convert.jmid_state_dict`` and saves the state_dict as one
``.npz`` of float32 arrays, keyed by parameter name. The port reads it with
numpy alone (``convert.load_npz``), so a machine without JAX, Flax or
Orbax runs the trained predictor. Prints the file's size.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHECKPOINT = os.path.join(ROOT, "checkpoints", "jmid_hallway")
OUT = os.path.join(ROOT, "weights", "jmid_hallway.npz")
WIDTHS = dict(context_dim=128, tf_layer=2)
# shipped checkpoints the port serves: name -> (ModelConfig widths, joint)
MODELS = {"jmid_hallway": (WIDTHS, True),
          "imid_eth_proof": (dict(context_dim=256, tf_layer=3), False),
          "jmid_mc_man_nod": (dict(context_dim=256, tf_layer=3,
                                   num_node_types=1), True)}


def reference_params(checkpoint=CHECKPOINT, widths=WIDTHS, joint=True):
    """The checkpoint's Flax parameter tree as numpy, read by the JAX
    package's reader into a template made at ``widths``
    (``ModelConfig`` fields) for a JMID (``joint``) or iMID model."""
    import jax
    from sicnav_tpu.diffusion import forecaster as FC
    from sicnav_tpu.diffusion.mid import JMIDModel, load_checkpoint
    from sicnav_tpu.diffusion.models import ModelConfig
    from sicnav_tpu.env import crowd_sim
    from sicnav_tpu.env.types import EnvConfig

    model = JMIDModel(ModelConfig(**widths), joint=joint)
    cfg = EnvConfig()
    fcfg = FC.ForecasterConfig(dt=cfg.dt)
    batch = FC._scene_batch_from_hist(FC.init_state(cfg.max_humans, fcfg),
                                      crowd_sim.reset_host(cfg, 0), fcfg)
    key = jax.random.PRNGKey(0)
    like = model.init({"params": key, "dropout": key}, batch, key)
    params = load_checkpoint(os.path.abspath(checkpoint), like)
    return jax.tree.map(np.asarray, params)


def convert(checkpoint=CHECKPOINT, widths=WIDTHS, joint=True):
    """{parameter name: float32 array} of the port's JMIDModel."""
    from sicnav_tpu_torch.convert import jmid_state_dict
    sd = jmid_state_dict(reference_params(checkpoint, widths, joint))
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--name", default="jmid_hallway", choices=sorted(MODELS))
    p.add_argument("--checkpoint", default=None,
                   help="default: checkpoints/<name>")
    p.add_argument("--out", default=None, help="default: weights/<name>.npz")
    args = p.parse_args(argv)
    widths, joint = MODELS[args.name]
    checkpoint = args.checkpoint or os.path.join(ROOT, "checkpoints",
                                                 args.name)
    out = args.out or os.path.join(ROOT, "weights", f"{args.name}.npz")
    arrays = convert(checkpoint, widths, joint)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"{out}: {len(arrays)} arrays, {n} parameters, "
          f"{os.path.getsize(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

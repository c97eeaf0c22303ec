#!/usr/bin/env python3
"""Write the trained hallway JMID predictor in the PyTorch port's layout.

    python scripts/convert_jmid_torch.py [--checkpoint checkpoints/jmid_hallway]
                                         [--out weights/jmid_hallway.npz]

Reads the Orbax checkpoint with the JAX package's own reader
(``sicnav_tpu.diffusion.mid.load_checkpoint``, at the shipped widths
``ModelConfig(context_dim=128, tf_layer=2)``), maps the Flax tree through
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


def reference_params(checkpoint=CHECKPOINT):
    """The checkpoint's Flax parameter tree as numpy, read by the JAX
    package's reader into a template made at the shipped widths."""
    import jax
    from sicnav_tpu.diffusion import forecaster as FC
    from sicnav_tpu.diffusion.mid import JMIDModel, load_checkpoint
    from sicnav_tpu.diffusion.models import ModelConfig
    from sicnav_tpu.env import crowd_sim
    from sicnav_tpu.env.types import EnvConfig

    model = JMIDModel(ModelConfig(**WIDTHS), joint=True)
    cfg = EnvConfig()
    fcfg = FC.ForecasterConfig(dt=cfg.dt)
    batch = FC._scene_batch_from_hist(FC.init_state(cfg.max_humans, fcfg),
                                      crowd_sim.reset_host(cfg, 0), fcfg)
    key = jax.random.PRNGKey(0)
    like = model.init({"params": key, "dropout": key}, batch, key)
    params = load_checkpoint(os.path.abspath(checkpoint), like)
    return jax.tree.map(np.asarray, params)


def convert(checkpoint=CHECKPOINT):
    """{parameter name: float32 array} of the port's JMIDModel."""
    from sicnav_tpu_torch.convert import jmid_state_dict
    sd = jmid_state_dict(reference_params(checkpoint))
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=CHECKPOINT)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    arrays = convert(args.checkpoint)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"{args.out}: {len(arrays)} arrays, {n} parameters, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

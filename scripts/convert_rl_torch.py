#!/usr/bin/env python3
"""Write the shipped SARL and RGL value networks in the PyTorch port's layout.

    python scripts/convert_rl_torch.py [--names sarl rgl]

Restores ``checkpoints/sarl_200k`` and ``checkpoints/rgl_200k`` (Orbax) with
the JAX package's reader, into templates of the reference networks at the
published widths (3 human slots), as ``scripts/eval_suite.py --policy
sarl|rgl --checkpoint ...`` restores them. Maps each Flax tree through
``sicnav_tpu_torch.convert.sarl_state_dict`` / ``rgl_state_dict`` and saves
the state_dict as ``weights/<name>_200k.npz``, float32 arrays keyed by
parameter name, which the port reads with numpy alone
(``convert.load_npz``). Prints each file's size.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def checkpoint(name):
    return os.path.join(ROOT, "checkpoints", f"{name}_200k")


def out_path(name):
    return os.path.join(ROOT, "weights", f"{name}_200k.npz")


def reference_params(name, path=None):
    """The checkpoint's Flax parameter tree as numpy."""
    import jax
    import jax.numpy as jnp
    from sicnav_tpu.diffusion.mid import load_checkpoint
    from sicnav_tpu.rl.networks import RGLNetwork, SARLNetwork

    net = SARLNetwork() if name == "sarl" else RGLNetwork()
    H = 3
    like = net.init(jax.random.PRNGKey(0), jnp.zeros(9), jnp.zeros((H, 5)),
                    jnp.ones(H, bool))
    params = load_checkpoint(os.path.abspath(path or checkpoint(name)), like)
    return jax.tree.map(np.asarray, params)


def convert(name, path=None):
    """{parameter name: float32 array} of the port's network."""
    from sicnav_tpu_torch import convert as C
    to_sd = C.sarl_state_dict if name == "sarl" else C.rgl_state_dict
    sd = to_sd(reference_params(name, path))
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--names", nargs="+", default=["sarl", "rgl"],
                   choices=["sarl", "rgl"])
    args = p.parse_args(argv)
    for name in args.names:
        arrays = convert(name)
        out = out_path(name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(out, **arrays)
        n = sum(a.size for a in arrays.values())
        print(f"{out}: {len(arrays)} arrays, {n} parameters, "
              f"{os.path.getsize(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

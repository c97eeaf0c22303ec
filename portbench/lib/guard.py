"""The import guard: nothing the benchmark runs may load JAX or the JAX
package. Module names are compared by their top-level name whole, since
``sicnav_tpu_torch`` begins with ``sicnav_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sicnav_tpu")


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)

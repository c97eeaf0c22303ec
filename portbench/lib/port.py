"""The program under test, as one namespace of modules.

``namespace("port")`` is sicnav_tpu_torch, the system the benchmark
measures. ``namespace("frozen")`` is the frozen copy under
``portbench/reference/frozen``, which the reference and the control run.
Both have the same modules and functions, so a driver runs either one.
Nothing here imports a module of the program until it is asked for.
"""

from __future__ import annotations

import importlib
import types
from pathlib import Path

import numpy as np
import torch

from portbench.lib.registry import ROOT

BASES = {"port": "sicnav_tpu_torch", "frozen": "portbench.reference.frozen"}
MODULES = {
    "crowd_sim": "env.crowd_sim", "env_types": "env.types",
    "FC": "diffusion.forecaster", "kde": "diffusion.kde",
    "mid": "diffusion.mid", "models": "diffusion.models",
    "SD": "mpc.sicnav_diffusion", "C": "mpc.campc", "ipm": "mpc.ipm",
    "realtime": "realtime", "dwa": "policies.dwa",
    "geometry": "ops.geometry",
}
KDE_OPS = {"port": "ops.kde_cuda", "frozen": "ops.kde_plain"}


def namespace(kind: str = "port") -> types.SimpleNamespace:
    base = BASES[kind]
    ns = types.SimpleNamespace(kind=kind)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{base}.{mod}"))
    ns.kde_ops = importlib.import_module(f"{base}.{KDE_OPS[kind]}")
    return ns


def set_tf32(on: bool):
    """TF32 for float32 matrix products: off for the program and the
    reference, as the configurations state; on for the control only."""
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)


def load_weights(path: str) -> dict:
    """The ``.npz`` state_dict as CPU tensors, read with numpy: a raw file
    that the program and the reference both take."""
    with np.load(Path(ROOT) / path) as z:
        return {k: torch.from_numpy(np.array(z[k])) for k in z.files}


def model_config(ns, cfg: dict):
    return ns.models.ModelConfig(**cfg["model"]["widths"])


def jmid_model(ns, cfg: dict, state_dict: dict, device, dtype=torch.float32):
    """The configuration's JMID / iMID model on ``device`` holding
    ``state_dict``, in ``dtype``."""
    model = ns.mid.JMIDModel(model_config(ns, cfg),
                             joint=cfg["model"]["joint"], device=device)
    model.load_state_dict(state_dict)
    return model.to(dtype)


def policy_kwargs(cfg: dict) -> dict:
    """The configuration's controller options, as
    ``mpc/sicnav_diffusion.make_policy`` takes them."""
    m = cfg["mpc"]
    return {"close_to_preds": m["close_to_preds"],
            "door_yield": m["door_yield"], "ral": m["ral"],
            "goal_dynamics": m["goal_dynamics"],
            "mpc_overrides": dict(m["overrides"])}


def check_ocp(cfg: dict, ocp):
    """The OCP that the options built has the sizes the configuration
    states, which the operation counts take."""
    m = cfg["mpc"]
    got = (ocp.cfg.n_z, ocp.cfg.n_z + ocp.n_eq)
    if got != (m["n_z"], m["kkt_dim"]):
        raise ValueError(f"the configuration states n_z, kkt_dim = "
                         f"{m['n_z']}, {m['kkt_dim']}; its options build "
                         f"{got}")


def index(tree, i):
    """Episode ``i`` of a batched NamedTuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[index(x, i) for x in tree])
    return tree[i]


def forecaster_config(ns, cfg: dict, env_cfg):
    return ns.FC.ForecasterConfig(dt=env_cfg.dt, **cfg["forecaster"])


def ipm_settings(ns, wl: dict, n_humans: int):
    """The traffic's solver budget: a fixed iteration count, or the
    streaming controller's real-time table."""
    if wl["ipm"] == "realtime":
        return ns.ipm.realtime_settings(n_humans, with_mid=True)
    return ns.ipm.IPMSettings(n_iter=int(wl["ipm"]))


def to_double(tree):
    """Float tensors of a NamedTuple tree, a dict or a tensor in float64."""
    if torch.is_tensor(tree):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: to_double(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_double(x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_double(x) for x in tree)
    return tree


def generators_like(states, device):
    """Generators on ``device`` set to each recorded state."""
    gens = []
    for s in states:
        g = torch.Generator(device=device)
        g.set_state(s)
        gens.append(g)
    return gens

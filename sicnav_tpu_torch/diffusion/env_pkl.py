"""The reference's ``Environment``-pkl dataset format (twin of
``sicnav_tpu/diffusion/env_pkl.py``).

Processed trajectory datasets of the original MID stack are dill pickles of
``environment.Environment`` objects holding ``Scene``s of ``Node``s with
``DoubleHeaderNumpyArray`` state matrices. This module reads and writes
them without that package:

- ``install_shims`` registers attribute-compatible shim classes under the
  same module paths (``environment.environment.Environment`` and so on),
  so pickle streams that name them resolve; ``load_environment(path)``
  reads such a pkl and ``save_environment(path, env)`` writes one whose
  class paths resolve against the original package too.
- ``environment_to_scene_arrays`` / ``arrays_to_environment`` convert
  between the pkl schema and the port's (A, T, 2) track arrays
  (``diffusion/data.py``), and ``environment_to_examples`` slices a pkl
  into ``SceneBatch`` examples.

``dill`` is imported when a pkl is read or written, and only then; without
it those two functions raise an ImportError that names it. A scene's
by-value-pickled ``aug_func`` is ignored on load (rotation augmentation is
``data.rotate_scene``).
"""

from __future__ import annotations

import sys
import types
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

from sicnav_tpu_torch.diffusion.data import derivative_of

STANDARDIZATION_PED = {
    "PEDESTRIAN": {
        "position": {"x": {"mean": 0, "std": 1}, "y": {"mean": 0, "std": 1}},
        "velocity": {"x": {"mean": 0, "std": 2}, "y": {"mean": 0, "std": 2}},
        "acceleration": {"x": {"mean": 0, "std": 1},
                         "y": {"mean": 0, "std": 1}},
    }
}

DATA_HEADER = [("position", "x"), ("position", "y"),
               ("velocity", "x"), ("velocity", "y"),
               ("acceleration", "x"), ("acceleration", "y")]


# --- shim classes (attribute-compatible with the original package's) -----

class NodeType:
    """NodeType shim (``environment.node_type``)."""

    def __init__(self, name, value):
        self.name = name
        self.value = value

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        if isinstance(other, str):
            return self.name == other
        return isinstance(other, NodeType) and self.name == other.name

    def __hash__(self):
        return hash(self.name)

    def __add__(self, other):
        return self.name + other


class NodeTypeEnum(list):
    """NodeTypeEnum shim: a list of NodeType."""

    def __init__(self, node_type_list):
        self.node_type_list = node_type_list
        super().__init__(NodeType(name, node_type_list.index(name) + 1)
                         for name in node_type_list)

    def __getattr__(self, name):
        lst = object.__getattribute__(self, "__dict__").get(
            "node_type_list", [])
        if not name.startswith("_") and name in lst:
            return self[lst.index(name)]
        return object.__getattribute__(self, name)


class DoubleHeaderNumpyArray:
    """DoubleHeaderNumpyArray shim: a (T, D) array with a double header
    [(h1, h2), ...], indexed by dict, list or tuple."""

    def __init__(self, data: np.ndarray, header: list):
        self.data = data
        self.header = header
        self.double_header_lookup = OrderedDict()
        self.tree_header_lookup = OrderedDict()
        for i, item in enumerate(header):
            self.double_header_lookup[item] = i
            self.tree_header_lookup.setdefault(item[0], dict())[item[1]] = i

    def __getitem__(self, item):
        rows, columns = item
        idx = []
        if isinstance(columns, dict):
            for h1, h2s in columns.items():
                for h2 in h2s:
                    idx.append(self.tree_header_lookup[h1][h2])
        elif isinstance(columns, list):
            idx = [self.double_header_lookup[c] for c in columns]
        else:
            return self.data[rows, self.double_header_lookup[columns]]
        return self.data[rows][:, idx]

    @property
    def shape(self):
        return self.data.shape


class Node:
    """Node shim (``environment.node``)."""

    def __init__(self, node_type, node_id, data, length=None, width=None,
                 height=None, first_timestep=0, is_robot=False,
                 description="", frequency_multiplier=1, non_aug_node=None,
                 aux_data=None):
        self.type = node_type
        self.id = node_id
        self.length = length
        self.width = width
        self.height = height
        self.first_timestep = first_timestep
        self.non_aug_node = non_aug_node
        self._aux_data = aux_data
        self.data = data
        self.is_robot = is_robot
        self._last_timestep = None
        self.description = description
        self.frequency_multiplier = frequency_multiplier
        self.forward_in_time_on_next_override = False

    @property
    def timesteps(self):
        return 0 if self.data is None else self.data.shape[0]

    @property
    def last_timestep(self):
        if self._last_timestep is None:
            self._last_timestep = self.first_timestep + self.timesteps - 1
        return self._last_timestep

    def __repr__(self):
        return "/".join([self.type.name, str(self.id)])


class Scene:
    """Scene shim (``environment.scene``)."""

    def __init__(self, timesteps, map=None, dt=1, name="",
                 frequency_multiplier=1, aug_func=None, non_aug_scene=None,
                 normalized_px=False, img_width=0, img_height=0):
        self.map = map
        self.timesteps = timesteps
        self.dt = dt
        self.name = name
        self.nodes = []
        self.robot = None
        self.temporal_scene_graph = None
        self.frequency_multiplier = frequency_multiplier
        self.description = ""
        self.aug_func = aug_func
        self.non_aug_scene = non_aug_scene
        self.normalized_px = normalized_px
        self.img_width = img_width
        self.img_height = img_height

    def __repr__(self):
        return (f"Scene: Duration: {self.timesteps * self.dt}s,"
                f" Nodes: {len(self.nodes)}")


class Environment:
    """Environment shim (``environment.environment``)."""

    def __init__(self, node_type_list, standardization, scenes=None,
                 attention_radius=None, robot_type=None, dt=None):
        self.scenes = scenes
        self.node_type_list = node_type_list
        self.attention_radius = attention_radius
        self.NodeType = NodeTypeEnum(node_type_list)
        self.robot_type = robot_type
        if dt is not None:
            self.dt = dt
        self.standardization = standardization
        self.standardize_param_memo = dict()
        self._scenes_resample_prop = None


_SHIM_MAP = {
    "environment.node_type": {"NodeType": NodeType,
                              "NodeTypeEnum": NodeTypeEnum},
    "environment.data_structures": {
        "DoubleHeaderNumpyArray": DoubleHeaderNumpyArray},
    "environment.node": {"Node": Node},
    "environment.scene": {"Scene": Scene},
    "environment.environment": {"Environment": Environment},
    "environment.data_utils": {"derivative_of": derivative_of},
}


def install_shims(force: bool = False):
    """Register the shim classes under the original package's module paths
    so pickle streams naming e.g. ``environment.node.Node`` resolve. A
    no-op if a real ``environment`` package is already imported (pkls then
    round-trip against the real classes); shims installed earlier, by this
    module or by its twin, are replaced."""
    if not force and "environment" in sys.modules and not getattr(
            sys.modules["environment"], "_sicnav_tpu_shim", False):
        return
    pkg = types.ModuleType("environment")
    pkg.__path__ = []
    pkg._sicnav_tpu_shim = True
    sys.modules["environment"] = pkg
    for mod_name, symbols in _SHIM_MAP.items():
        mod = types.ModuleType(mod_name)
        for name, cls in symbols.items():
            cls.__module__ = mod_name
            setattr(mod, name, cls)
            setattr(pkg, name, cls)
        sys.modules[mod_name] = mod


def _dill():
    try:
        import dill
    except ImportError as err:
        raise ImportError("reading or writing an Environment pkl needs the "
                          "dill package, which is not installed") from err
    return dill


def load_environment(path) -> Environment:
    """Read an Environment pkl (dill)."""
    dill = _dill()
    install_shims()
    with open(path, "rb") as f:
        # such pkls are written with dill; ignore=True keeps loading when a
        # by-value-pickled aug_func names missing globals
        try:
            return dill.load(f)
        except Exception:
            f.seek(0)
            return dill.load(f, ignore=True)


def save_environment(path, env: Environment):
    """Write an Environment pkl (dill) whose class paths are the original
    package's."""
    dill = _dill()
    install_shims()
    with open(path, "wb") as f:
        dill.dump(env, f, protocol=dill.HIGHEST_PROTOCOL)


# --- schema <-> track-array converters ------------------------------------

def environment_to_scene_arrays(env) -> List[Tuple[str, float, np.ndarray,
                                                   np.ndarray]]:
    """Environment -> [(scene_name, dt, pos (A, T, 2), valid (A, T))]."""
    out = []
    for scene in env.scenes or []:
        T = int(scene.timesteps)
        nodes = list(scene.nodes)
        A = len(nodes)
        pos = np.zeros((A, T, 2), np.float32)
        valid = np.zeros((A, T), bool)
        for a, node in enumerate(nodes):
            d = node.data
            arr = d.data if hasattr(d, "data") else np.asarray(d)
            hdr = d.header if hasattr(d, "header") else DATA_HEADER
            ix = hdr.index(("position", "x"))
            iy = hdr.index(("position", "y"))
            t0 = int(node.first_timestep)
            n = min(arr.shape[0], T - t0)
            pos[a, t0:t0 + n, 0] = arr[:n, ix]
            pos[a, t0:t0 + n, 1] = arr[:n, iy]
            valid[a, t0:t0 + n] = True
        out.append((scene.name, float(scene.dt), pos, valid))
    return out


def arrays_to_environment(scenes: List[Tuple[str, float, np.ndarray,
                                             np.ndarray]],
                          node_type: str = "PEDESTRIAN") -> Environment:
    """[(name, dt, pos (A, T, 2), valid (A, T))] -> Environment, built as
    the original processing builds it: per-node contiguous [pos, vel, acc]
    matrices with finite-difference derivatives over each node's span,
    first_timestep offsets, a 3.0 m attention radius."""
    install_shims()
    env = Environment(node_type_list=[node_type],
                      standardization=STANDARDIZATION_PED)
    nt = getattr(env.NodeType, node_type)
    env.attention_radius = {(nt, nt): 3.0}
    env_scenes = []
    for name, dt, pos, valid in scenes:
        A, T, _ = pos.shape
        scene = Scene(timesteps=T, dt=dt, name=str(name))
        for a in range(A):
            ts = np.nonzero(valid[a])[0]
            if ts.size < 2:
                continue
            t0, t1 = int(ts[0]), int(ts[-1])
            x = pos[a, t0:t1 + 1, 0].astype(np.float64)
            y = pos[a, t0:t1 + 1, 1].astype(np.float64)
            vx, vy = derivative_of(x, dt), derivative_of(y, dt)
            ax, ay = derivative_of(vx, dt), derivative_of(vy, dt)
            data = DoubleHeaderNumpyArray(
                np.stack([x, y, vx, vy, ax, ay], axis=-1), list(DATA_HEADER))
            scene.nodes.append(Node(nt, str(a), data, first_timestep=t0))
        env_scenes.append(scene)
    env.scenes = env_scenes
    return env


def environment_to_examples(env, history_len=6, horizon=8, max_agents=None,
                            stride=1):
    """Environment pkl -> list of SceneBatch training examples."""
    from sicnav_tpu_torch.diffusion.data import build_examples
    out = []
    for _, dt, pos, valid in environment_to_scene_arrays(env):
        out.extend(build_examples(pos, valid, dt, history_len=history_len,
                                  horizon=horizon, max_agents=max_agents,
                                  stride=stride))
    return out

"""The port's Environment-pkl interchange (``sicnav_tpu_torch.diffusion.
env_pkl``) against the reference's (``sicnav_tpu.diffusion.env_pkl``),
and ``scripts/process_data_torch.py`` against ``scripts/process_data.py``.

A pkl written by either package is read by the other into the same
scenes (positions within 1e-5, the pkl's float32-to-float64 round trip;
masks, names and dt exact) and the same examples; the processing scripts
write the same arrays from the same files. Without ``dill`` the pkl
functions raise an ImportError that names it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sicnav_tpu.diffusion import env_pkl as EP_ref
from sicnav_tpu_torch.diffusion import env_pkl as EP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tracks(seed=0, A=4, T=30):
    rng = np.random.default_rng(seed)
    start = rng.uniform(-4, 4, (A, 2))
    vel = rng.uniform(-1, 1, (A, 2))
    t = np.arange(T)[None, :, None]
    pos = start[:, None, :] + vel[:, None, :] * t * 0.4
    valid = np.ones((A, T), bool)
    valid[0, :5] = False     # late entry
    valid[1, -6:] = False    # early exit
    return pos.astype(np.float32), valid


def same_scenes(a, b):
    assert len(a) == len(b) > 0
    for (n1, dt1, p1, v1), (n2, dt2, p2, v2) in zip(a, b):
        assert n1 == n2 and dt1 == dt2
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_allclose(p1[v1], p2[v2], rtol=0, atol=1e-5)


def same_examples(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in x._fields:
            gx, gy = getattr(x, f), getattr(y, f)
            if gx is None or gy is None:
                assert gx is None and gy is None
                continue
            np.testing.assert_allclose(gx, gy, rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("writer,reader", [(EP, EP_ref), (EP_ref, EP)],
                         ids=["port_writes", "reference_writes"])
def test_pkl_round_trip_across_packages(writer, reader, tmp_path):
    scenes = [("scene0", 0.4, *tracks(0)), ("scene1", 0.4, *tracks(1, A=3))]
    path = tmp_path / "x.pkl"
    writer.save_environment(str(path), writer.arrays_to_environment(scenes))
    env = reader.load_environment(str(path))
    assert type(env).__name__ == "Environment"
    assert type(env).__module__ == "environment.environment"
    same_scenes(reader.environment_to_scene_arrays(env),
                [(n, dt, p, v) for n, dt, p, v in scenes])
    # both packages slice the pkl into the same examples
    same_examples(EP.environment_to_examples(env, max_agents=5),
                  EP_ref.environment_to_examples(env, max_agents=5))


def test_shim_schema_matches_the_reference():
    """The shims carry the same attributes and module paths as the
    reference's, so a pkl of either names the same classes."""
    pos, valid = tracks(2)
    a = EP.arrays_to_environment([("s", 0.4, pos, valid)])
    b = EP_ref.arrays_to_environment([("s", 0.4, pos, valid)])
    assert set(vars(a)) == set(vars(b))
    assert set(vars(a.scenes[0])) == set(vars(b.scenes[0]))
    assert set(vars(a.scenes[0].nodes[0])) == set(vars(b.scenes[0].nodes[0]))
    for x, y in zip(a.scenes[0].nodes, b.scenes[0].nodes):
        np.testing.assert_array_equal(x.data.data, y.data.data)
        assert x.first_timestep == y.first_timestep and x.id == y.id
        assert x.data[:, {"velocity": ["x", "y"]}].shape == \
            y.data[:, {"velocity": ["x", "y"]}].shape
    for name, mod in (("Environment", "environment.environment"),
                      ("Scene", "environment.scene"),
                      ("Node", "environment.node"),
                      ("NodeType", "environment.node_type"),
                      ("DoubleHeaderNumpyArray",
                       "environment.data_structures")):
        assert getattr(EP, name).__module__ == mod


def test_without_dill_the_pkl_functions_raise(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "dill", None)
    env = EP.arrays_to_environment([("s", 0.4, *tracks(3))])
    with pytest.raises(ImportError, match="dill"):
        EP.save_environment(str(tmp_path / "x.pkl"), env)
    with pytest.raises(ImportError, match="dill"):
        EP.load_environment(str(tmp_path / "x.pkl"))


def test_process_data_scripts_agree(tmp_path):
    """process_data_torch.py and process_data.py on the same ETH-format
    files write the same examples; each script's pkl loads in the other
    package."""
    files = []
    for i in range(2):
        pos, valid = tracks(10 + i, A=5, T=24)
        path = tmp_path / f"scene{i}.txt"
        with open(path, "w") as f:
            for t in range(pos.shape[1]):
                for a in range(pos.shape[0]):
                    if valid[a, t]:
                        f.write(f"{10 * t}\t{a}\t{pos[a, t, 0]:.4f}\t"
                                f"{pos[a, t, 1]:.4f}\n")
        files.append(str(path))
    out = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for name in ("process_data.py", "process_data_torch.py"):
        stem = name.split(".")[0]
        cmd = [sys.executable, os.path.join(ROOT, "scripts", name), *files,
               "--augment_rotations", "1", "--out",
               str(tmp_path / f"{stem}.npz"), "--pkl_out",
               str(tmp_path / f"{stem}.pkl")]
        subprocess.run(cmd, check=True, cwd=ROOT, env=env,
                       capture_output=True, timeout=300)
        with np.load(tmp_path / f"{stem}.npz") as z:
            out[stem] = {k: z[k] for k in z.files}
    a, b = out["process_data"], out["process_data_torch"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    same_scenes(
        EP.environment_to_scene_arrays(EP.load_environment(
            str(tmp_path / "process_data.pkl"))),
        EP_ref.environment_to_scene_arrays(EP_ref.load_environment(
            str(tmp_path / "process_data_torch.pkl"))))

"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file has a plain ``extern "C"`` interface and includes
no PyTorch header, so one ``nvcc`` call builds them all into
``libsicnav_kernels.so`` in seconds; Python binds it with ``ctypes``.

The library is built at first use into ``build/kernels/<key>/`` beside the
package (a directory git ignores), keyed by a hash of the sources and the
flags, and written under a temporary name and renamed into place, so a
build that is cut off never leaves a half-written library behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
LIB_NAME = "libsicnav_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    tried = ["PATH"]
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        tried.append(str(c))
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found; tried " + ", ".join(tried))


def build_library() -> Path:
    """Build ``libsicnav_kernels.so`` unless a build of the same sources and
    flags exists; returns its path. The compiler's output (ptxas register
    and shared-memory report) is kept in ``build_log``."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        key.update(src.name.encode())
        key.update(src.read_bytes())
    out_dir = BUILD_DIR / key.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.sicnav_kde_loglik.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.sicnav_kde_loglik.restype = ctypes.c_int
        _lib = lib
    return _lib

"""Build the CUDA kernels with one ``nvcc`` call and load them with ctypes.

``csrc/*.cu`` (the band rasterizer K1/K2 and the z-buffer K3) compile into
``_build/<content-hash>/libspt_kernels.so``, a shared library with a plain C
interface. The build happens at first use.
nvcc writes into a temporary file beside the target, which ``os.replace``
then moves into place, so a build that is cut off leaves no partial library
and no lock for a later build to wait on.

PyTorch's own extension loader is deliberately not used: a source that
includes PyTorch's headers takes minutes to compile, and the loader waits
forever on the lock file of a build that was cut off.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libspt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300
DEFAULT_CUDA_HOME = "/usr/local/cuda"   # the CUDA toolkit's default prefix

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _content_hash() -> str:
    h = hashlib.sha256()
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this content has not been built; return the
    library's path. Raises if nvcc is missing or the build fails."""
    out_dir = os.path.join(BUILD_ROOT, _content_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tmp = "%s.tmp-%d" % (lib_path, os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc took more than %d s" % BUILD_TIMEOUT_S) from e
    if proc.returncode != 0 or not os.path.isfile(tmp):
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed (rc %d):\n%s" % (
            proc.returncode, (proc.stdout + proc.stderr)[-4000:]))
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spt_band_raster_fwd.argtypes = [p] * 9 + [i] * 6 + [f, f, p]
        lib.spt_band_raster_fwd.restype = i
        lib.spt_band_raster_bwd.argtypes = [p] * 4 + [i] * 3 + [f, p]
        lib.spt_band_raster_bwd.restype = i
        lib.spt_band_raster_resources.argtypes = [p]
        lib.spt_band_raster_resources.restype = i
        lib.spt_zbuffer_bary.argtypes = [p] * 10 + [i] * 6 + [f, p]
        lib.spt_zbuffer_bary.restype = i
        _LIB = lib
        return lib

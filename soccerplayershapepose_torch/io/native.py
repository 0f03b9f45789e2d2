"""ctypes binding of the native host dataplane (``native/libdataplane.so``).

Counterpart of ``soccerplayershapepose_tpu/io/native.py``: the port binds
the same committed library (manifest scans, the .npy parser and the
multi-threaded proxy-batch loader, ``native/dataplane.cc``). Where the
library is absent or does not load, every function takes its pure-Python
path, which gives the same results; :func:`native_available` says which
path runs. The port does not build the library: ``make -C native`` does.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB_PATH = os.path.join(_REPO_ROOT, "native", "libdataplane.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.dp_scan_tree.restype = ctypes.c_void_p
    lib.dp_scan_tree.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.dp_free.restype = None
    lib.dp_free.argtypes = [ctypes.c_void_p]
    lib.dp_load_npy_f32.restype = ctypes.c_int
    lib.dp_load_npy_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.dp_load_proxy_batch.restype = ctypes.c_int
    lib.dp_load_proxy_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def scan_tree(root: str, suffix: str = "") -> List[str]:
    """Relative paths of files under root matching suffix (sorted DFS)."""
    lib = _load()
    if lib is None:
        out = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if not suffix or name.endswith(suffix):
                    out.append(os.path.relpath(os.path.join(dirpath, name),
                                               root))
        return out
    ptr = lib.dp_scan_tree(root.encode(), suffix.encode())
    if not ptr:
        return []
    try:
        text = ctypes.string_at(ptr).decode()
    finally:
        lib.dp_free(ptr)
    return [line for line in text.split("\n") if line]


def load_npy_f32(path: str) -> np.ndarray:
    """Load a ≤2-D .npy as float32 (native parser when available)."""
    lib = _load()
    if lib is None:
        return np.load(path).astype(np.float32)
    buf = np.empty(1 << 22, np.float32)     # 16 MB scratch: up to 2048²
    dims = (ctypes.c_int64 * 2)()
    rc = lib.dp_load_npy_f32(path.encode(), _f32_ptr(buf), buf.size, dims)
    if rc != 0:
        return np.load(path).astype(np.float32)   # e.g. >2-D
    rows, cols = dims[0], dims[1]
    return buf[:rows * cols].reshape(rows, cols).copy()


def load_proxy_batch(stems: List[str], wh: int = 512,
                     n_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Batched (<stem>_sil.npy, <stem>_j2d.xml) load → ((B,wh,wh), (B,17,3))."""
    lib = _load()
    b = len(stems)
    if lib is None:
        sils = np.stack([np.load(s + "_sil.npy").astype(np.float32)
                         for s in stems])
        joints = []
        for s in stems:
            with open(s + "_j2d.xml") as f:
                joints.append(np.asarray(json.load(f), np.float32))
        return sils, np.stack(joints)
    sil = np.empty((b, wh, wh), np.float32)
    j2d = np.empty((b, 17, 3), np.float32)
    packed = b"\0".join(s.encode() for s in stems) + b"\0"
    rc = lib.dp_load_proxy_batch(packed, b, wh, _f32_ptr(sil), _f32_ptr(j2d),
                                 n_threads)
    if rc != 0:
        raise IOError(f"proxy load failed for stem #{-rc}: {stems[-rc - 1]}")
    return sil, j2d

"""ctypes bindings for the native preprocessing kernels, with auto-build.

The port's own copy of `open_ludwig_tpu/native/__init__.py`, with the
Bouzidi maps returned over the geometry's reach, not the whole grid.  The
library is compiled from `preprocess.cpp` on first use with the reference's
flags (g++ -O3 -march=native -shared -fPIC) into `build/native/` beside the
package (git-ignored); its name carries a hash of the source and the flags,
so an edited source rebuilds.  Without a toolchain the callers fall back to
the vectorized numpy implementations in domain/voxelize.py and
domain/bouzidi.py, and a WARNING says so: the two paths differ in q by up
to 2e-3.  `available()` tells which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("open_ludwig_torch")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "preprocess.cpp")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_tried = False


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpreprocess_{digest.hexdigest()[:16]}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _lib_path()
    if not os.path.isfile(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        except (OSError, subprocess.SubprocessError) as e:
            if os.path.exists(tmp):
                os.remove(tmp)
            log.warning("[native] build failed (%s); using numpy preprocessing", e)
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.voxelize_sat.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.voxelize_sat.restype = None
        lib.bouzidi_box.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bouzidi_box.restype = None
        lib.bouzidi_raycast.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bouzidi_raycast.restype = None
        _lib = lib
    except OSError as e:
        log.warning("[native] load failed (%s); using numpy preprocessing", e)
    return _lib


def available() -> bool:
    return _load() is not None


def voxelize_sat(verts: np.ndarray, dx: float, dims) -> Optional[np.ndarray]:
    """Native SAT shell voxelization; returns None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    out = np.zeros(int(np.prod(dims)), np.uint8)
    lib.voxelize_sat(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)), ctypes.c_double(dx),
        ctypes.c_int64(dims[0]), ctypes.c_int64(dims[1]), ctypes.c_int64(dims[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.reshape(dims).astype(bool)


def bouzidi_raycast(
    verts: np.ndarray, dx: float, dims
) -> Optional[Tuple[Tuple[int, int, int], np.ndarray, np.ndarray]]:
    """Native Bouzidi q over the geometry's reach, the union of the cells the
    triangles' rays can reach clipped to the grid: returns the box's lower
    corner and its (EX, EY, EZ, 27) float32 q and int32 nearest-triangle maps,
    or None without the library."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    v_ptr = v.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    box = np.zeros(6, np.int64)
    box_ptr = box.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.bouzidi_box(
        v_ptr, ctypes.c_int64(len(v)), ctypes.c_double(dx),
        ctypes.c_int64(dims[0]), ctypes.c_int64(dims[1]), ctypes.c_int64(dims[2]),
        box_ptr,
    )
    corner = tuple(int(c) for c in box[:3])
    extent = tuple(int(e) for e in box[3:])
    n = int(np.prod(extent))
    q = np.zeros(n * 27, np.float32)
    tri = np.full(n * 27, -1, np.int32)
    lib.bouzidi_raycast(
        v_ptr, ctypes.c_int64(len(v)), ctypes.c_double(dx), box_ptr,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return corner, q.reshape(extent + (27,)), tri.reshape(extent + (27,))

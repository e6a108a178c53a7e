"""Build and load the CUDA kernels of `csrc/` (nvcc -> shared library -> ctypes).

Each kernel source is compiled once into its own shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>_<hash>.so
         open_ludwig_torch/csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.  The
build directory is `build/kernels/` beside the package (git-ignored).
Nothing here runs at import; the first kernel launch builds.  There is no
fast-math flag: the wall model's pow/log and the WALE square roots must
match the plain version to 1e-5.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Built:
    lib: ctypes.CDLL
    path: str
    seconds: float  # 0.0 when the library was already built
    ptxas_log: str


_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "open_ludwig_torch/csrc cannot be built"
    )


def load(name: str) -> Built:
    """Build (if needed) and load csrc/<name>.cu; raises on any failure."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    log_path = lib_path[:-3] + ".log"
    seconds = 0.0
    if not os.path.isfile(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(log_path, "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    with open(log_path) as fh:
        ptxas_log = fh.read()
    built = Built(ctypes.CDLL(lib_path), lib_path, seconds, ptxas_log)
    _LOADED[name] = built
    return built

"""Build and load the CUDA kernels of `csrc/` (nvcc -> shared library -> ctypes).

Each kernel source is compiled once into its own shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>_<hash>.so
         open_ludwig_torch/csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source rebuilds and an unchanged
one loads the library already built.  The build directory is
`build/kernels/` beside the package (git-ignored).  Nothing here runs at
import; the first kernel launch builds.  `load_all` starts one nvcc per
source at once.  `load(name, csrc=DIR, extra=flags)` builds the same
kernel from another source directory (an earlier version of `csrc/`, for a
comparison on the card) or with extra flags (a measurement build) into its
own library, loaded beside the package's own; `substituted` lets the
wrappers launch such a library for the length of a `with` block.  There is no fast-math flag: the wall model's pow/log and
the WALE square roots must match the plain version to 1e-5.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# every kernel source of csrc/, as chip_smoke.py builds them at once
KERNELS = ("stream_collide", "bouzidi", "fused_pair", "stream_collide_flat",
           "stream_collide_inplace", "bouzidi_ab", "ghost_planes")
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


def _key(name: str, csrc: Optional[str], extra: Tuple[str, ...]) -> str:
    """The _LOADED key of kernel `name` built from `csrc` (None: CSRC) with
    the extra nvcc flags `extra`."""
    where = CSRC if csrc is None else os.path.abspath(csrc)
    return " ".join((name, where) + tuple(extra))


def _paths(name: str, csrc: Optional[str], extra: Tuple[str, ...]
           ) -> Tuple[str, str, str]:
    """(source, library, ptxas log) of <csrc>/<name>.cu."""
    csrc = CSRC if csrc is None else os.path.abspath(csrc)
    src = os.path.join(csrc, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    digest.update(csrc.encode())
    for path in [src] + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    return src, lib_path, lib_path[:-3] + ".log"


def _start(name: str, csrc: Optional[str] = None, extra: Tuple[str, ...] = ()
           ) -> Optional[Tuple[subprocess.Popen, str, float]]:
    """Start nvcc for <csrc>/<name>.cu unless its library is built."""
    if _key(name, csrc, extra) in _LOADED:
        return None
    src, lib_path, _ = _paths(name, csrc, extra)
    if os.path.isfile(lib_path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, tmp, time.perf_counter()


def _finish(name: str, started, csrc: Optional[str] = None,
            extra: Tuple[str, ...] = ()) -> Built:
    """Wait for the build started by _start (if any) and load the library;
    raises on any failure."""
    key = _key(name, csrc, extra)
    if key in _LOADED:
        return _LOADED[key]
    src, lib_path, log_path = _paths(name, csrc, extra)
    seconds = 0.0
    if started is not None:
        proc, tmp, t0 = started
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n{out}\n{err}"
            )
        with open(log_path, "w") as fh:
            fh.write(out + err)
        os.replace(tmp, lib_path)
    with open(log_path) as fh:
        ptxas_log = fh.read()
    built = Built(ctypes.CDLL(lib_path), lib_path, seconds, ptxas_log)
    _LOADED[key] = built
    return built


def load(name: str, csrc: Optional[str] = None, extra: Sequence[str] = ()
         ) -> Built:
    """Build (if needed) and load <csrc>/<name>.cu (default: the package's
    csrc/) with the extra nvcc flags `extra` (e.g. a -D of a measurement
    build); raises on any failure.  Every launch calls load(name): a
    library already loaded returns at once."""
    extra = tuple(extra)
    built = _LOADED.get(_key(name, csrc, extra))
    if built is not None:
        return built
    return _finish(name, _start(name, csrc, extra), csrc, extra)


@contextlib.contextmanager
def substituted(name: str, built: Built) -> Iterator[None]:
    """Within the block, the wrappers launch `built` (a library with the
    same C interface, built from another source directory or with other
    flags) as kernel `name`: a measurement's swap, never a fallback."""
    key = _key(name, None, ())
    old = _LOADED.get(key)
    _LOADED[key] = built
    try:
        yield
    finally:
        if old is None:
            _LOADED.pop(key, None)
        else:
            _LOADED[key] = old


def load_all(names: Iterable[str]) -> List[Built]:
    """load() for several sources, their nvcc processes running at once."""
    names = list(names)
    started = []
    try:
        for n in names:
            started.append(_start(n))
        return [_finish(n, s) for n, s in zip(names, started)]
    finally:  # a failed build leaves no nvcc running
        for s in started:
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()

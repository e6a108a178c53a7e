"""Checkpoint / resume in the JAX package's format 1.

Port of `open_ludwig_tpu/checkpoint.py`: a plain numpy .npz (a zip of
.npy members, stored uncompressed) of {f, rho, vel} per level plus the
step counter, the level count and the format version.  Member names are
the reference's, `L{level}_{key}.npy`; a bfloat16 member is written as
its 16-bit pattern under a uint16 `.npy` header (descr '<u2', what the
reference's `_fetch_chunks` writes for bf16) and tagged
`L{level}_{key}__bf16.npy`.  Keys starting with "_" (the carried
ghost-plane slabs "_ifsl") are derived, not saved: `run.seed_slabs`
recomputes them from the state on resume.

The port's arrays are the unpadded (..., X, Y, Z) interior; the JAX
package's are padded or flat-(y, z).  `convert.checkpoint_from_jax` /
`checkpoint_to_jax` rewrite a file for the other package.

Memory: `save_checkpoint` first fetches every saved tensor of every level
to host memory (`fetch_members`, synchronous: the run's next launches
may overwrite the device buffers), then writes the zip (`write_members`,
on a background thread with `async_write`, to a temporary name renamed
when complete).  So the host holds one whole copy of the saved state
(f, rho and vel of every level: 0.76 GB for the 10.8M-cell bf16 level)
until the write ends, and the next save waits for it first.  The
reference's module docstring (`checkpoint.py:12`) claims one chunk; its
`save_checkpoint` also builds every member before the writer starts.
"""

from __future__ import annotations

import glob
import io
import os
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import storage

FORMAT_VERSION = 1
BF16_TAG = "__bf16"

_pending_lock = threading.Lock()
_pending: Optional[threading.Thread] = None


def _npy_header(shape, dtype) -> bytes:
    bio = io.BytesIO()
    np.lib.format.write_array_header_2_0(
        bio,
        {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
         "fortran_order": False, "shape": tuple(shape)},
    )
    return bio.getvalue()


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its own (a copy, also on the CPU: the
    run goes on updating its buffers); bfloat16 as its uint16 bits."""
    h = t.detach().to("cpu", copy=True).contiguous()
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.uint16)
    return h.numpy()


def from_host(arr: np.ndarray, bf16: bool, device="cpu") -> torch.Tensor:
    """The inverse of `to_host`: a bf16 member's uint16 bits back to
    torch.bfloat16, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def fetch_members(step: int, states: List[Dict]) -> List[Tuple[str, np.ndarray]]:
    """The checkpoint's members, (name, host array), for `states`: every
    tensor not under a "_" key, copied to the host."""
    members = [
        ("step.npy", np.asarray(np.int64(step))),
        ("n_levels.npy", np.asarray(np.int64(len(states)))),
        ("format_version.npy", np.asarray(np.int64(FORMAT_VERSION))),
    ]
    for i, st in enumerate(states):
        for key, t in st.items():
            if key.startswith("_"):
                continue
            tag = BF16_TAG if t.dtype == torch.bfloat16 else ""
            members.append((f"L{i}_{key}{tag}.npy", to_host(t)))
    return members


def write_members(path: str, members: List[Tuple[str, np.ndarray]]) -> None:
    """Write the zip to `path` + ".tmp" and rename it to `path`."""
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in members:
            with zf.open(name, "w", force_zip64=True) as fh:
                if arr.ndim == 0:
                    np.lib.format.write_array(fh, arr)
                    continue
                fh.write(_npy_header(arr.shape, arr.dtype))
                fh.write(arr.reshape(-1).view(np.uint8))
    os.replace(tmp, path)


def wait_pending() -> None:
    """Block until the previous async checkpoint write (if any) is on disk."""
    global _pending
    with _pending_lock:
        th = _pending
    if th is not None:
        th.join()
    with _pending_lock:
        if _pending is th:
            _pending = None


def save_checkpoint(
    path_dir: str, step: int, states: List[Dict], async_write: bool = False
) -> str:
    """Save states to <path_dir>/ckpt_<step>.npz.  The host fetch is
    synchronous; with async_write the zip/disk write runs on a background
    thread and the file appears (atomically) when done."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"ckpt_{step:08d}.npz")
    # one writer at a time (also orders files for latest_checkpoint)
    wait_pending()
    members = fetch_members(step, states)
    if not async_write:
        write_members(path, members)
        return path
    global _pending
    th = threading.Thread(target=write_members, args=(path, members),
                          daemon=False, name=f"ckpt-write-{step}")
    with _pending_lock:
        _pending = th
    th.start()
    return path


def latest_checkpoint(path_dir: str) -> Optional[str]:
    wait_pending()  # a file mid-write must not be invisible to resume
    files = sorted(glob.glob(os.path.join(path_dir, "ckpt_*.npz")))
    return files[-1] if files else None


def read_members(path: str) -> Tuple[int, List[Dict[str, Tuple[np.ndarray, bool]]]]:
    """The step and, per level, {key: (host array, bf16)} of a checkpoint
    of either package (bf16 members as their uint16 bits)."""
    with np.load(path) as data:
        ver = int(data["format_version"]) if "format_version" in data else 0
        if ver > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {ver} newer than supported")
        levels = []
        for i in range(int(data["n_levels"])):
            lv = {}
            for key in ("f", "rho", "vel"):
                tagged = f"L{i}_{key}{BF16_TAG}"
                if tagged in data:
                    lv[key] = (data[tagged], True)
                else:
                    lv[key] = (data[f"L{i}_{key}"], False)
            levels.append(lv)
        return int(data["step"]), levels


def load_checkpoint(path: str, precision: Optional[str] = None,
                    device="cpu") -> Tuple[int, List[Dict]]:
    """Load a port checkpoint onto `device`.  With `precision` given, f is
    converted to that storage type where its stored type differs (a run
    resumed after changing advanced.numerics.precision); where it is
    already that type it is kept bit for bit (the reference re-encodes it
    always, which rounds g below w's float32 ulp)."""
    step, levels = read_members(path)
    states = []
    for lv in levels:
        st = {key: from_host(arr, bf16, device) for key, (arr, bf16) in lv.items()}
        if precision is not None and st["f"].dtype != storage.f_dtype(precision):
            st["f"] = storage.encode_f(storage.decode_f(st["f"]), precision)
        states.append(st)
    return step, states

"""Carry state between the JAX package and the port.

Inputs are numpy arrays as the JAX package hands them over
(`np.asarray(jax_array)`); outputs are the port's tensors, and back.  The
JAX package stores every level padded to its TPU tile (`patch.padded`),
or on a flat-(y,z) level (`patch.flat_yz`) as (..., XS, M) with
n = y * Z + z and a pad tail up to M = ceil(Y * Z, 128), with flat (N,)
statics; the port stores the interior (..., X, Y, Z) only.  bf16 g-storage
crosses bit-exactly through a 16-bit integer view.

`patch` below is always a JAX package level: its attributes (`interior`,
`padded`, `flat_yz`, `flat_m`, ...) are read by name, and nothing here
imports the JAX package or jax.  A level of the blocks layout (a
`LevelGeometry` of either package, which has a `block_ptr`) has no
padding: its (27, nb, 512) float32 arrays carry over as they are, so
`state_from_jax`, `state_to_jax` and the checkpoint rewrites take it too.  `level_from_jax` gives the port's level
for one.  `checkpoint_from_jax` / `checkpoint_to_jax` rewrite a format-1
checkpoint file for the other package, so a run resumes across them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import checkpoint as ckpt
from . import lattice as lat
from .core.patch import PatchLevel


def trim(arr: np.ndarray, interior: Sequence[int]) -> np.ndarray:
    """(..., XS, YS, ZS) -> (..., X, Y, Z)."""
    X, Y, Z = interior
    return np.asarray(arr)[..., :X, :Y, :Z]


def pad(arr: np.ndarray, padded: Sequence[int], fill=0) -> np.ndarray:
    """(..., X, Y, Z) -> (..., XS, YS, ZS), pad cells = fill."""
    arr = np.asarray(arr)
    out = np.full(arr.shape[:-3] + tuple(padded), fill, arr.dtype)
    X, Y, Z = arr.shape[-3:]
    out[..., :X, :Y, :Z] = arr
    return out


def unflatten_host(arr: np.ndarray, patch) -> np.ndarray:
    """A flat-(y,z) JAX level array (..., XS, M) -> (..., XS, Y, Z) over the
    interior y/z (open_ludwig_tpu/core/patch.py:119-126); identity on a
    3-D level."""
    arr = np.asarray(arr)
    if not patch.flat_yz:
        return arr
    Y, Z = patch.interior[1], patch.interior[2]
    return arr[..., :Y * Z].reshape(arr.shape[:-1] + (Y, Z))


def _blocks(level) -> bool:
    """A level of the blocks layout."""
    return hasattr(level, "block_ptr")


def from_jax_layout(arr: np.ndarray, patch) -> np.ndarray:
    """A JAX level array, (..., XS, YS, ZS) or flat (..., XS, M), -> the
    interior (..., X, Y, Z); a blocks level's array as it is."""
    if _blocks(patch):
        return np.asarray(arr)
    return trim(unflatten_host(arr, patch), patch.interior)


def level_from_jax(patch) -> PatchLevel:
    """The port's level for a JAX package level: the same box, faces, tau
    and Bouzidi data, its static fields ((XS, YS, ZS) on every JAX level)
    cut to the interior."""
    X, Y, Z = patch.interior
    statics = {key: trim(getattr(patch, key), patch.interior).copy()
               for key in ("obstacle", "sponge", "wall_dist")}
    return PatchLevel(
        level_id=patch.level_id, dx=patch.dx, tau=patch.tau,
        lo=tuple(patch.lo), interior=(X, Y, Z), face_bc=tuple(patch.face_bc),
        bouzidi=patch.bouzidi, **statics)


def to_jax_layout(arr: np.ndarray, patch, fill=0) -> np.ndarray:
    """(..., X, Y, Z) -> the JAX level's layout, (..., XS, M) on a flat
    level, else (..., XS, YS, ZS); pad cells and slots take `fill`, a
    scalar or an array broadcast over the leading axes (for f: w or 0, the
    JAX rest state).  A blocks level's array as it is."""
    arr = np.asarray(arr)
    if _blocks(patch):
        return arr
    lead = arr.shape[:-3]
    X, Y, Z = arr.shape[-3:]
    tail = (patch.padded[0], patch.flat_m) if patch.flat_yz else tuple(patch.padded)
    out = np.empty(lead + tail, arr.dtype)
    fill = np.asarray(fill, arr.dtype)
    out[...] = fill.reshape(fill.shape + (1,) * (out.ndim - fill.ndim))
    if patch.flat_yz:
        out[..., :X, :Y * Z] = arr.reshape(lead + (X, Y * Z))
    else:
        out[..., :X, :Y, :Z] = arr
    return out


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> tensor; a bfloat16 numpy array (ml_dtypes, as jax returns)
    is carried over bit-exactly as torch.bfloat16.  A read-only array (a
    view of a jax buffer) is copied: the port's in-place step writes its f."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 values come back as the float32 they equal."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def state_from_jax(state: Dict, patch, device="cpu") -> Dict:
    """A JAX level state {f, rho, vel} (padded or flat, f32 or bf16 g) ->
    port."""
    return {
        key: to_tensor(from_jax_layout(state[key], patch), device)
        for key in ("f", "rho", "vel")
    }


def state_to_numpy(state: Dict) -> Dict[str, np.ndarray]:
    return {key: to_numpy(state[key]) for key in ("f", "rho", "vel")}


def state_to_jax(state: Dict, patch) -> Dict[str, np.ndarray]:
    """A port level state -> numpy arrays in the JAX level's layout, pads at
    the JAX rest state (f = w, or g = 0 on bf16; rho = 1; vel = 0).  bf16 g
    comes back as the float32 values it holds, which cast back to bfloat16
    exactly."""
    bf16 = state["f"].dtype == torch.bfloat16
    w = np.zeros(27, np.float32) if bf16 else lat.W.astype(np.float32)
    arrs = state_to_numpy(state)
    return {
        "f": to_jax_layout(arrs["f"], patch, w),
        "rho": to_jax_layout(arrs["rho"], patch, 1.0),
        "vel": to_jax_layout(arrs["vel"], patch, 0.0),
    }


def bouzidi_S_from_jax(plan_jax: Dict, patch,
                       port_lo: Sequence[int], port_dim: Sequence[int]) -> np.ndarray:
    """Embed the JAX plan's tile-aligned S box into a full-level array and
    crop the port's tight box out of it."""
    full = np.zeros((27,) + tuple(patch.padded), np.float32)
    lx, ly, lz = plan_jax["lo"]
    bx, by, bz = plan_jax["dim"]
    full[:, lx:lx + bx, ly:ly + by, lz:lz + bz] = np.asarray(plan_jax["S"])
    px, py, pz = port_lo
    qx, qy, qz = port_dim
    return full[:, px:px + qx, py:py + qy, pz:pz + qz].copy()


def embed_S(plan: Dict, interior: Sequence[int]) -> np.ndarray:
    """A plan's S box embedded into a full (27, X, Y, Z) level array."""
    full = np.zeros((27,) + tuple(interior), np.float32)
    lx, ly, lz = plan["lo"]
    bx, by, bz = plan["dim"]
    S = plan["S"]
    full[:, lx:lx + bx, ly:ly + by, lz:lz + bz] = (
        to_numpy(S) if isinstance(S, torch.Tensor) else np.asarray(S)
    )
    return full


def statics_from_jax(static: Dict, patch, port_plan: Optional[Dict],
                     device="cpu") -> Dict:
    """JAX statics (flat padded obstacle/sponge/wall_dist + aligned Bouzidi
    plan) -> port statics for the same level."""
    out = {}
    for key in ("obstacle", "sponge", "wall_dist"):
        arr = np.asarray(static[key]).reshape(patch.state_shape)
        out[key] = to_tensor(from_jax_layout(arr, patch), device)
    bz = None
    if static.get("bouzidi") is not None and port_plan is not None:
        S = bouzidi_S_from_jax(static["bouzidi"], patch,
                               port_plan["lo"], port_plan["dim"])
        bz = {**port_plan, "S": to_tensor(S, device)}
    out["bouzidi"] = bz
    return out


def cell_index_from_jax(idx: np.ndarray, padded: Sequence[int],
                        interior: Sequence[int]) -> np.ndarray:
    """Flat cell indices in the padded (XS, YS, ZS) strides -> the
    unpadded (X, Y, Z) strides."""
    x, y, z = np.unravel_index(np.asarray(idx, np.int64), tuple(padded))
    return np.ravel_multi_index((x, y, z), tuple(interior)).astype(np.int32)


def checkpoint_from_jax(path: str, jax_levels: Sequence, out_dir: str) -> str:
    """A JAX package checkpoint (padded or flat-(y, z) arrays) -> a port
    checkpoint of the same step in `out_dir` (its path): each level's
    arrays cut to the interior as `state_from_jax` cuts them, bf16 bits
    kept."""
    step, levels = ckpt.read_members(path)
    if len(levels) != len(jax_levels):
        raise ValueError(f"{path} holds {len(levels)} levels, not {len(jax_levels)}")
    states = [{key: ckpt.from_host(from_jax_layout(arr, p), bf16)
               for key, (arr, bf16) in lv.items()}
              for lv, p in zip(levels, jax_levels)]
    return ckpt.save_checkpoint(out_dir, step, states)


def checkpoint_to_jax(path: str, jax_levels: Sequence, out_dir: str) -> str:
    """A port checkpoint -> a JAX package checkpoint of the same step in
    `out_dir` (its path), each level in its JAX layout with pads at the
    JAX rest state (`state_to_jax`), bf16 g re-cast exactly."""
    step, states = ckpt.load_checkpoint(path)
    if len(states) != len(jax_levels):
        raise ValueError(f"{path} holds {len(states)} levels, not {len(jax_levels)}")
    out = []
    for st, p in zip(states, jax_levels):
        arrs = state_to_jax(st, p)
        out.append({key: torch.from_numpy(arrs[key]).to(st[key].dtype)
                    for key in ("f", "rho", "vel")})
    return ckpt.save_checkpoint(out_dir, step, out)

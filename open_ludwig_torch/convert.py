"""Carry state between the JAX package and the port.

Inputs are numpy arrays as the JAX package hands them over
(`np.asarray(jax_array)`); outputs are the port's tensors, and back.  The
JAX package stores every level padded to its TPU tile (`patch.padded`)
with flat (N,) statics; the port stores the interior only.  bf16 g-storage
crosses bit-exactly through a 16-bit integer view.  Nothing here imports
jax.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from open_ludwig_tpu.core.patch import PatchLevel


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


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> tensor; a bfloat16 numpy array (ml_dtypes, as jax returns)
    is carried over bit-exactly as torch.bfloat16."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 values come back as the float32 they equal."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def state_from_jax(state: Dict, patch: PatchLevel, device="cpu") -> Dict:
    """A JAX level state {f, rho, vel} (padded, f32 or bf16 g) -> port."""
    return {
        key: to_tensor(trim(state[key], patch.interior), device)
        for key in ("f", "rho", "vel")
    }


def state_to_numpy(state: Dict) -> Dict[str, np.ndarray]:
    return {key: to_numpy(state[key]) for key in ("f", "rho", "vel")}


def bouzidi_S_from_jax(plan_jax: Dict, patch: PatchLevel,
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


def statics_from_jax(static: Dict, patch: PatchLevel, port_plan: Optional[Dict],
                     device="cpu") -> Dict:
    """JAX statics (flat padded obstacle/sponge/wall_dist + aligned Bouzidi
    plan) -> port statics for the same level."""
    out = {}
    for key in ("obstacle", "sponge", "wall_dist"):
        arr = np.asarray(static[key]).reshape(patch.padded)
        out[key] = to_tensor(trim(arr, patch.interior), device)
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

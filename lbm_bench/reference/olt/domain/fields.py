# Frozen copy of open_ludwig_torch/domain/fields.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""Static per-cell fields: sponge damping and near-wall distance.

The port's own copy of `open_ludwig_tpu/domain/fields.py`.  Sponge:
cosine-ramped damping toward freestream near domain faces (reference:
src/domain_generation.jl:205-289).  Wall distance: fluid cells
26-adjacent to an obstacle cell get the Euclidean neighbor distance * dx,
everything else the 100.0 sentinel (reference: src/domain_generation.jl:371-434).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BLOCK_EDGE = 8
WALL_DIST_SENTINEL = 100.0


def _smooth_profile(x: np.ndarray, thickness: float) -> np.ndarray:
    """1 at x<=0, cosine ramp to 0 at x>=thickness
    (reference: src/domain_generation.jl:205-213)."""
    out = 0.5 * (1.0 + np.cos(np.pi * np.clip(x, 0.0, thickness) / thickness))
    out = np.where(x <= 0.0, 1.0, out)
    return np.where(x >= thickness, 0.0, out)


def sponge_for_cells(
    px: np.ndarray,
    py: np.ndarray,
    pz: np.ndarray,
    domain_size: Tuple[float, float, float],
    sponge_thickness: float,
    symmetric: bool,
) -> np.ndarray:
    """Sponge strength for cell centers at physical coords (px, py, pz)."""
    Lx, Ly, Lz = domain_size
    outlet_thickness = Lx * max(float(sponge_thickness), 0.15)
    inlet_thickness = Lx * 0.02
    y_thick = Ly * float(sponge_thickness) * 0.5
    z_thick = Lz * float(sponge_thickness) * 0.5

    outlet_start = Lx - outlet_thickness
    y_top_start = Ly - y_thick
    z_back_start = Lz - z_thick

    s = np.zeros(px.shape, np.float64)
    # outlet (strength 1.0)
    d = px - outlet_start
    s = np.maximum(s, np.where(d > 0, _smooth_profile(outlet_thickness - d, outlet_thickness), 0.0))
    # inlet (0.05)
    s = np.maximum(s, np.where(px < inlet_thickness, 0.05 * _smooth_profile(px, inlet_thickness), 0.0))
    # lateral walls (0.1); skip y_min when symmetric
    if not symmetric:
        s = np.maximum(s, np.where(py < y_thick, 0.1 * _smooth_profile(py, y_thick), 0.0))
    d = py - y_top_start
    s = np.maximum(s, np.where(d > 0, 0.1 * _smooth_profile(y_thick - d, y_thick), 0.0))
    d = pz
    s = np.maximum(s, np.where(pz < z_thick, 0.1 * _smooth_profile(pz, z_thick), 0.0))
    d = pz - z_back_start
    s = np.maximum(s, np.where(d > 0, 0.1 * _smooth_profile(z_thick - d, z_thick), 0.0))
    return s.astype(np.float32)


def wall_distance_dense(obstacle: np.ndarray, dx: float) -> np.ndarray:
    """Dense (X, Y, Z) float32 wall distance: for fluid cells adjacent
    (26-neighborhood) to an obstacle cell, min neighbor Euclidean distance
    in physical units; 100.0 sentinel elsewhere.  Obstacle cells keep the
    sentinel (the kernel never reads them)."""
    dist = np.full(obstacle.shape, WALL_DIST_SENTINEL, np.float32)
    for ddz in (-1, 0, 1):
        for ddy in (-1, 0, 1):
            for ddx in (-1, 0, 1):
                if ddx == 0 and ddy == 0 and ddz == 0:
                    continue
                d = np.float32(np.sqrt(ddx**2 + ddy**2 + ddz**2) * dx)
                # neighbor at +offset is obstacle -> this cell is near-wall
                shifted = np.zeros(obstacle.shape, bool)
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                for ax, o in enumerate((ddx, ddy, ddz)):
                    if o == 1:
                        src[ax] = slice(1, None)
                        dst[ax] = slice(0, -1)
                    elif o == -1:
                        src[ax] = slice(0, -1)
                        dst[ax] = slice(1, None)
                shifted[tuple(dst)] = obstacle[tuple(src)]
                dist = np.where(shifted & (dist > d), d, dist)
    dist[obstacle] = WALL_DIST_SENTINEL
    return dist

# Frozen copy of open_ludwig_torch/domain/voxelize.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""Voxelization (SAT shell marking) and interior flood fill, vectorized.

The port's own copy of `open_ludwig_tpu/domain/voxelize.py`.  The
reference marks "shell" cells by a per-cell triangle/AABB separating-axis
test with box half-size 0.75*dx and fills watertight interiors by BFS from
the min-x boundary (reference: src/domain_generation.jl:10-203).  Here the loops
are inverted: we enumerate candidate cells per triangle (its AABB expanded by
the SAT box), run one batched SAT over all (cell, triangle) pairs, and use a
connected-component labeling for the flood fill.

Per the reference, the SAT test checks the 3 slab axes and the 9 edge-cross
axes only (it omits the triangle-normal axis), with a 1.001 tolerance on the
half-size — reproduced here since it determines which cells become obstacles.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

BLOCK_EDGE = 8


def _sat_pairs(centers: np.ndarray, tris: np.ndarray, h: float) -> np.ndarray:
    """Batched SAT triangle/AABB overlap for P (cell, triangle) pairs.

    centers: (P, 3), tris: (P, 3, 3) already in domain coordinates.
    h: box half-size (scalar, already including the 1.001 tolerance).
    Returns (P,) bool overlap mask.
    """
    t = tris - centers[:, None, :]  # (P, 3corner, 3xyz)
    ok = np.ones(len(t), bool)
    # slab tests
    tmin = t.min(axis=1)
    tmax = t.max(axis=1)
    ok &= np.all((tmin <= h) & (tmax >= -h), axis=1)
    if not ok.any():
        return ok
    # edge-cross axes: f_j = edges, axes = cross(u_i, f_j)
    f = np.stack([t[:, 1] - t[:, 0], t[:, 2] - t[:, 1], t[:, 0] - t[:, 2]], axis=1)
    for j in range(3):
        fj = f[:, j]  # (P, 3)
        for i in range(3):
            if i == 0:
                axis = np.stack([np.zeros(len(fj)), -fj[:, 2], fj[:, 1]], axis=1)
            elif i == 1:
                axis = np.stack([fj[:, 2], np.zeros(len(fj)), -fj[:, 0]], axis=1)
            else:
                axis = np.stack([-fj[:, 1], fj[:, 0], np.zeros(len(fj))], axis=1)
            deg = np.einsum("pi,pi->p", axis, axis) < 1e-10
            p = np.einsum("pci,pi->pc", t, axis)  # (P, 3) projections
            r = h * np.abs(axis).sum(axis=1)
            sep = (p.min(axis=1) > r) | (p.max(axis=1) < -r)
            ok &= deg | ~sep
    return ok


def voxelize_dense(
    verts: np.ndarray,
    dx: float,
    grid_dims: Tuple[int, int, int],
    chunk: int = 2_000_000,
    use_native: bool = True,
) -> np.ndarray:
    """Dense (X, Y, Z) bool shell mask.  verts: (n_tri, 3, 3) in domain coords
    (mesh offset already applied).  Cell centers at (g + 0.5) * dx."""
    if use_native:
        from ..native import voxelize_sat as native_voxelize

        out = native_voxelize(verts, dx, grid_dims)
        if out is not None:
            return out
    X, Y, Z = grid_dims
    obstacle = np.zeros(grid_dims, bool)
    h = 0.75 * dx * 1.001
    t_min = verts.min(axis=1)
    t_max = verts.max(axis=1)
    lo = np.floor((t_min - h) / dx - 0.5).astype(np.int64) + 1
    hi = np.floor((t_max + h) / dx - 0.5).astype(np.int64)
    # center (g+0.5)dx within [tmin-h, tmax+h]
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, np.asarray(grid_dims) - 1)
    span = np.maximum(hi - lo + 1, 0)
    n_cells = span.prod(axis=1)
    total = int(n_cells.sum())
    if total == 0:
        return obstacle
    tri_of = np.repeat(np.arange(len(verts)), n_cells)
    starts = np.concatenate([[0], np.cumsum(n_cells)[:-1]])
    local = np.arange(total) - np.repeat(starts, n_cells)
    sx = np.repeat(span[:, 0], n_cells)
    sy = np.repeat(span[:, 1], n_cells)
    gx = np.repeat(lo[:, 0], n_cells) + local % sx
    gy = np.repeat(lo[:, 1], n_cells) + (local // sx) % sy
    gz = np.repeat(lo[:, 2], n_cells) + local // (sx * sy)
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        cen = (np.stack([gx[s:e], gy[s:e], gz[s:e]], axis=1) + 0.5) * dx
        hit = _sat_pairs(cen, verts[tri_of[s:e]], h)
        obstacle[gx[s:e][hit], gy[s:e][hit], gz[s:e][hit]] = True
    return obstacle


def flood_fill_dense(
    obstacle: np.ndarray, active_cells: np.ndarray, min_x_block: int
) -> np.ndarray:
    """Mark unreachable non-shell cells as solid (watertight interior fill).

    Traversal runs 6-connected through non-obstacle cells of active blocks,
    seeded from every fluid cell in blocks at the min-x active block column
    (reference: src/domain_generation.jl:114-203).  Returns the augmented
    obstacle mask."""
    traversable = active_cells & ~obstacle
    labels, _ = ndimage.label(traversable, structure=ndimage.generate_binary_structure(3, 1))
    x0 = min_x_block * BLOCK_EDGE
    seeds = labels[x0 : x0 + BLOCK_EDGE][traversable[x0 : x0 + BLOCK_EDGE]]
    outside = np.unique(seeds)
    outside = outside[outside > 0]
    interior = traversable & ~np.isin(labels, outside)
    return obstacle | interior

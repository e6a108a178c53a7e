# Frozen copy of open_ludwig_torch/ops/forces.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""The map of each surface triangle to its fluid cells on the finest level,
for the surface-stress forces.

Port of `open_ludwig_tpu/ops/forces.py`, cut to the host build of the
patch layout's map (`build_triangle_cell_map_dense`, `_second_sample`):
each STL triangle is mapped once, in numpy, to its nearest fluid cell
(expanding-shell semantics, reference: src/forces/surface.jl:138-266) and
to a second cell along its outward normal for the wall extrapolation of
the pressure.  A patch level's cell indices are flat in the port's
unpadded (X, Y, Z) strides.  The evaluation itself is the reference's own
(`lbm_bench/reference/model.plain_forces`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..geometry import TriMesh
from ..scaling import DomainParams

def _second_sample(tc, n_hat, bc, has, dx, dims, is_fluid):
    """Second pressure sample along the OUTWARD surface normal for wall
    extrapolation: nearest fluid cell to the point one cell further out
    than the first sample's normal-projected distance.  Returns
    (cell_coords2, has2, d1n, d2n) with distances normal-projected in
    lattice units."""
    cc1 = (bc + 0.5) * dx
    d1n = np.einsum("ij,ij->i", cc1 - tc, n_hat)
    d1n = np.maximum(d1n, 0.1 * dx)  # guard: first cell on the surface plane
    target = tc + n_hat * (d1n + 1.0 * dx)[:, None]
    off2 = np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)
    g2 = np.floor(target / dx).astype(np.int64)
    cand = g2[:, None, :] + off2[None, :, :]
    valid = np.all((cand >= 0) & (cand < dims[None, None, :]), axis=2)
    cc = np.clip(cand, 0, dims - 1)
    fluid = valid & is_fluid(cc)
    cent = (cand + 0.5) * dx
    dd = np.sum((cent - target[:, None, :]) ** 2, axis=2)
    dd = np.where(fluid, dd, np.inf)
    b2 = np.argmin(dd, axis=1)
    has2 = np.isfinite(dd[np.arange(len(b2)), b2])
    bc2 = cc[np.arange(len(b2)), b2]
    d2n = np.einsum("ij,ij->i", (bc2 + 0.5) * dx - tc, n_hat)
    # meaningful separation along the normal, and a distinct cell
    has2 &= has & (d2n - d1n > 0.25 * dx) & ~np.all(bc2 == bc, axis=1)
    return bc2, has2, d1n / dx, d2n / dx


def build_triangle_cell_map_dense(
    mesh: TriMesh,
    patch,
    params: DomainParams,
    search_radius: int = 5,
    chunk: int = 4096,
) -> Dict[str, np.ndarray]:
    """Triangle -> nearest fluid cell of the finest level's dense box
    (patch-local coordinates), flat indices in unpadded (X, Y, Z) strides."""
    dx = patch.dx
    offset = np.asarray(params.mesh_offset)
    lo = np.asarray(patch.lo)
    centers = mesh.centers + offset[None, :] - lo[None, :] * dx  # patch-local
    n_tri = len(centers)
    X, Y, Z = patch.interior
    obstacle = patch.obstacle[:X, :Y, :Z]

    r = search_radius
    off = np.stack(
        np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                    np.arange(-r, r + 1), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    shell = np.abs(off).max(axis=1)
    order = np.argsort(shell, kind="stable")
    off = off[order]
    shell = shell[order]

    cell_idx = np.zeros(n_tri, np.int64)
    wall_dist = np.full(n_tri, 0.5, np.float64)
    found = np.zeros(n_tri, bool)
    cell_idx2 = np.zeros(n_tri, np.int64)
    found2 = np.zeros(n_tri, bool)
    dn1 = np.full(n_tri, 0.5, np.float64)
    dn2 = np.full(n_tri, 1.5, np.float64)
    dims = np.array([X, Y, Z])
    for s in range(0, n_tri, chunk):
        e = min(s + chunk, n_tri)
        tc = centers[s:e]
        g0 = np.floor(tc / dx).astype(np.int64)
        cand = g0[:, None, :] + off[None, :, :]
        valid = np.all((cand >= 0) & (cand < dims[None, None, :]), axis=2)
        cc = np.clip(cand, 0, dims - 1)
        fluid = valid & ~obstacle[cc[..., 0], cc[..., 1], cc[..., 2]]
        cell_cent = (cand + 0.5) * dx
        d2 = np.sum((cell_cent - tc[:, None, :]) ** 2, axis=2)
        d2 = np.where(fluid, d2, np.inf)
        first_shell = np.where(
            fluid.any(axis=1), shell[np.argmax(fluid, axis=1)], r + 1
        )
        allowed = shell[None, :] <= np.minimum(first_shell + 1, r)[:, None]
        d2 = np.where(allowed, d2, np.inf)
        best = np.argmin(d2, axis=1)
        has = np.isfinite(d2[np.arange(len(best)), best])
        bc = cc[np.arange(len(best)), best]
        flat = (bc[:, 0] * Y + bc[:, 1]) * Z + bc[:, 2]
        cell_idx[s:e] = np.where(has, flat, 0)
        found[s:e] = has
        wd = np.sqrt(d2[np.arange(len(best)), best]) / dx
        wall_dist[s:e] = np.where(has, np.maximum(wd, 0.5), 0.5)

        bc2, has2, d1n, d2n = _second_sample(
            tc, mesh.normals[s:e], bc, has, dx, dims,
            lambda cc_: ~obstacle[cc_[..., 0], cc_[..., 1], cc_[..., 2]],
        )
        flat2 = (bc2[:, 0] * Y + bc2[:, 1]) * Z + bc2[:, 2]
        cell_idx2[s:e] = np.where(has2, flat2, 0)
        found2[s:e] = has2
        dn1[s:e] = d1n
        dn2[s:e] = np.where(has2, d2n, d1n + 1.0)
    return {
        "cell_idx": cell_idx.astype(np.int32),
        "wall_dist": wall_dist.astype(np.float32),
        "found": found,
        "cell_idx2": cell_idx2.astype(np.int32),
        "found2": found2,
        "dn1": dn1.astype(np.float32),
        "dn2": dn2.astype(np.float32),
    }

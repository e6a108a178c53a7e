"""Bouzidi boundary setup: per-cell, per-direction wall-intersection fractions.

The port's own copy of `open_ludwig_tpu/domain/bouzidi.py`, with
`should_use_bouzidi` (`open_ludwig_tpu/domain/builder.py:81-86`) beside it.

For every cell near the surface and each of the 26 lattice directions, find the
nearest ray/triangle intersection along the (normalized) direction; the
fraction q = t / (dx |c|) in (0, 1] is stored together with the triangle id
(reference: src/bouzidi_setup.jl:64-167, src/bouzidi_math.jl:9-102).

Vectorization: instead of per-block triangle lists and per-cell loops, we
enumerate (cell, triangle) candidate pairs from triangle AABBs expanded by the
maximum travel distance dx*sqrt(3) and run one batched Moller-Trumbore over
all pairs x 26 directions.  This is geometrically equivalent to the
reference's 2.5*dx-margin block-local search (travel never exceeds 1.74*dx).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..lattice import C_X, C_Y, C_Z

_EPS = 1e-9
_DIRS = np.stack([C_X, C_Y, C_Z], axis=1).astype(np.float64)  # (27, 3)
_DIR_NORM = np.linalg.norm(_DIRS, axis=1)
_VALID_K = np.where(_DIR_NORM > 0)[0]  # 26 moving directions


def should_use_bouzidi(level_id: int, num_levels: int, cfg) -> bool:
    """(reference: src/bouzidi_common.jl:28-34)"""
    if cfg.boundary_method != "bouzidi":
        return False
    return level_id > (num_levels - cfg.bouzidi_levels)


@dataclass(frozen=True)
class BouzidiData:
    """Sparse Bouzidi storage for one level (0-based global cell coords)."""

    cell_gx: np.ndarray  # (n_bcells,) int32
    cell_gy: np.ndarray
    cell_gz: np.ndarray
    q_map: np.ndarray  # (n_bcells, 27) float16, 0 = no intersection
    tri_map: np.ndarray  # (n_bcells, 27) int32, -1 = none

    @property
    def n_boundary_cells(self) -> int:
        return len(self.cell_gx)


def compute_bouzidi(
    verts: np.ndarray,
    dx: float,
    grid_dims: Tuple[int, int, int],
    active_cells: np.ndarray,
    chunk: int = 200_000,
    use_native: bool = True,
) -> BouzidiData:
    """verts: (n_tri, 3, 3) in domain coordinates (offset applied).

    active_cells: dense bool (X, Y, Z); only cells in active blocks produce
    entries (matching the reference's per-active-block loop)."""
    if use_native:
        from ..native import bouzidi_raycast as native_raycast

        res = native_raycast(verts, dx, grid_dims)
        if res is not None:
            corner, qd, trid = res
            box = tuple(slice(c, c + e) for c, e in zip(corner, qd.shape))
            qd = np.where(active_cells[box][..., None], qd, 0.0)
            hit = (qd > 0).any(axis=-1)
            cg = np.argwhere(hit) + np.asarray(corner)
            if len(cg) == 0:
                return _empty()
            return BouzidiData(
                cg[:, 0].astype(np.int32),
                cg[:, 1].astype(np.int32),
                cg[:, 2].astype(np.int32),
                qd[hit].astype(np.float16),
                np.where(qd[hit] > 0, trid[hit], -1).astype(np.int32),
            )
    reach = dx * np.sqrt(3.0)
    t_min = verts.min(axis=1) - reach
    t_max = verts.max(axis=1) + reach
    lo = np.floor(t_min / dx - 0.5).astype(np.int64) + 1
    hi = np.floor(t_max / dx - 0.5).astype(np.int64)
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, np.asarray(grid_dims) - 1)
    span = np.maximum(hi - lo + 1, 0)
    n_cells = span.prod(axis=1)
    total = int(n_cells.sum())
    if total == 0:
        return _empty()

    tri_of = np.repeat(np.arange(len(verts)), n_cells)
    starts = np.concatenate([[0], np.cumsum(n_cells)[:-1]])
    local = np.arange(total) - np.repeat(starts, n_cells)
    sx = np.repeat(span[:, 0], n_cells)
    sy = np.repeat(span[:, 1], n_cells)
    gx = (np.repeat(lo[:, 0], n_cells) + local % sx).astype(np.int64)
    gy = (np.repeat(lo[:, 1], n_cells) + (local // sx) % sy).astype(np.int64)
    gz = (np.repeat(lo[:, 2], n_cells) + local // (sx * sy)).astype(np.int64)

    keep = active_cells[gx, gy, gz]
    tri_of, gx, gy, gz = tri_of[keep], gx[keep], gy[keep], gz[keep]
    total = len(tri_of)
    if total == 0:
        return _empty()

    X, Y, Z = grid_dims
    cell_lin = (gx * Y + gy) * Z + gz

    rec_cell = []
    rec_k = []
    rec_q = []
    rec_tri = []

    dirs_n = _DIRS[_VALID_K] / _DIR_NORM[_VALID_K][:, None]  # (26, 3) unit
    qscale = 1.0 / (dx * _DIR_NORM[_VALID_K])  # q = t * qscale

    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        tri = verts[tri_of[s:e]]  # (P, 3, 3)
        origin = (np.stack([gx[s:e], gy[s:e], gz[s:e]], axis=1) + 0.5) * dx
        v1 = tri[:, 0]
        edge1 = tri[:, 1] - v1  # (P, 3)
        edge2 = tri[:, 2] - v1
        svec = origin - v1  # (P, 3)
        qvec = np.cross(svec, edge1)  # (P, 3)
        # loop 26 directions, vectorized over P pairs
        for ki, k in enumerate(_VALID_K):
            d = dirs_n[ki]
            h = np.cross(np.broadcast_to(d, edge2.shape), edge2)  # (P, 3)
            a = np.einsum("pi,pi->p", edge1, h)
            ok = np.abs(a) >= _EPS
            f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
            u = f * np.einsum("pi,pi->p", svec, h)
            ok &= (u >= 0.0) & (u <= 1.0)
            v = f * (qvec @ d)
            ok &= (v >= 0.0) & (u + v <= 1.0)
            t = f * np.einsum("pi,pi->p", edge2, qvec)
            ok &= t > _EPS
            q = t * qscale[ki]
            ok &= (q > 0.0) & (q <= 1.0)
            if not ok.any():
                continue
            rec_cell.append(cell_lin[s:e][ok])
            rec_k.append(np.full(ok.sum(), k, np.int32))
            rec_q.append(q[ok])
            rec_tri.append(tri_of[s:e][ok].astype(np.int32))

    if not rec_cell:
        return _empty()
    cells = np.concatenate(rec_cell)
    ks = np.concatenate(rec_k)
    qs = np.concatenate(rec_q)
    tris = np.concatenate(rec_tri)

    # nearest hit per (cell, k): stable sort by (cell, k, q), take first
    order = np.lexsort((qs, ks, cells))
    cells, ks, qs, tris = cells[order], ks[order], qs[order], tris[order]
    first = np.ones(len(cells), bool)
    first[1:] = (cells[1:] != cells[:-1]) | (ks[1:] != ks[:-1])
    cells, ks, qs, tris = cells[first], ks[first], qs[first], tris[first]

    ucells, inv = np.unique(cells, return_inverse=True)
    n = len(ucells)
    q_map = np.zeros((n, 27), np.float16)
    tri_map = np.full((n, 27), -1, np.int32)
    q_map[inv, ks] = qs.astype(np.float16)
    tri_map[inv, ks] = tris

    cgx = (ucells // (Y * Z)).astype(np.int32)
    cgy = ((ucells // Z) % Y).astype(np.int32)
    cgz = (ucells % Z).astype(np.int32)
    return BouzidiData(cgx, cgy, cgz, q_map, tri_map)


def _empty() -> BouzidiData:
    z = np.zeros(0, np.int32)
    return BouzidiData(z, z, z, np.zeros((0, 27), np.float16), np.full((0, 27), -1, np.int32))

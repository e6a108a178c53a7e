"""Block topology: active-set selection, halo/sibling closure, neighbor tables.

The port's own copy of `open_ludwig_tpu/domain/topology.py` (all eleven
functions, the same arrays: `tests/test_torch_blocks_host.py`).
Vectorized numpy re-implementation of the reference's set-based logic
(reference: src/domain_topology.jl, src/domain.jl:56-164).  Block coordinates
are 0-based triples into a dense (Bx, By, Bz) grid; active sets are boolean
occupancy masks so dilation / sibling closure are array ops instead of loops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..geometry import TriMesh

BLOCK_EDGE = 8


def blocks_from_mask(mask: np.ndarray) -> np.ndarray:
    """Sorted (nb, 3) int32 block coords from an occupancy mask.

    Sort order is lexicographic (bx, by, bz) to mirror the reference's
    sorted tuple order (reference: src/domain.jl:171)."""
    coords = np.argwhere(mask).astype(np.int32)  # sorted by (x, y, z) already
    return coords


def mask_from_blocks(coords: np.ndarray, dims: Tuple[int, int, int]) -> np.ndarray:
    mask = np.zeros(dims, bool)
    if len(coords):
        mask[coords[:, 0], coords[:, 1], coords[:, 2]] = True
    return mask


def dilate26(mask: np.ndarray) -> np.ndarray:
    """26-connected dilation by one block layer."""
    out = mask.copy()
    for ax in range(3):
        shifted_p = np.zeros_like(out)
        shifted_m = np.zeros_like(out)
        src_p = [slice(None)] * 3
        dst_p = [slice(None)] * 3
        src_p[ax] = slice(0, -1)
        dst_p[ax] = slice(1, None)
        shifted_p[tuple(dst_p)] = out[tuple(src_p)]
        src_m = [slice(None)] * 3
        dst_m = [slice(None)] * 3
        src_m[ax] = slice(1, None)
        dst_m[ax] = slice(0, -1)
        shifted_m[tuple(dst_m)] = out[tuple(src_m)]
        out = out | shifted_p | shifted_m
    return out


def complete_siblings(mask: np.ndarray) -> np.ndarray:
    """Add all 8 children of every parent that has at least one active child."""
    dims = mask.shape
    pdims = tuple((d + 1) // 2 for d in dims)
    parent = np.zeros(pdims, bool)
    # OR-reduce the 2x2x2 octets
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                sub = mask[dx::2, dy::2, dz::2]
                parent[: sub.shape[0], : sub.shape[1], : sub.shape[2]] |= sub
    out = np.zeros(dims, bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                tgt = out[dx::2, dy::2, dz::2]
                tgt |= parent[: tgt.shape[0], : tgt.shape[1], : tgt.shape[2]]
    return out


def add_halo_with_siblings(mask: np.ndarray, layers: int) -> np.ndarray:
    """Per layer: one 26-dilation, then sibling completion of the new blocks
    (reference: src/domain_topology.jl:54-99)."""
    out = mask.copy()
    for _ in range(layers):
        new = dilate26(out) & ~out
        sibs = complete_siblings(new) & ~out & ~new
        out = out | new | sibs
    return out


def ensure_parent_coverage(mask: np.ndarray, max_iter: int = 10) -> np.ndarray:
    """Fixpoint sibling-octet completion of the whole active set
    (reference: src/domain_topology.jl:101-133)."""
    out = mask.copy()
    for _ in range(max_iter):
        full = complete_siblings(out)
        if full.sum() == out.sum():
            break
        out = full
    return out


def geometry_active_mask(
    mesh: TriMesh,
    dx: float,
    mesh_offset: np.ndarray,
    dims: Tuple[int, int, int],
) -> np.ndarray:
    """Blocks whose AABB overlaps any triangle's AABB (+1% dx margin)
    (reference: src/domain_topology.jl:9-52)."""
    margin = dx * 0.01
    inv = 1.0 / (BLOCK_EDGE * dx)
    verts = mesh.vertices + mesh_offset[None, None, :]
    t_min = verts.min(axis=1)
    t_max = verts.max(axis=1)
    lo = np.floor((t_min - margin) * inv).astype(np.int64)
    hi = np.floor((t_max + margin) * inv).astype(np.int64)
    lo = np.clip(lo, 0, np.asarray(dims) - 1)
    hi = np.clip(hi, 0, np.asarray(dims) - 1)
    mask = np.zeros(dims, bool)
    span = hi - lo + 1
    n_cells = span.prod(axis=1)
    # Expand ragged per-triangle boxes into one flat list of block coords
    total = int(n_cells.sum())
    if total == 0:
        return mask
    tri_of = np.repeat(np.arange(len(verts)), n_cells)
    starts = np.concatenate([[0], np.cumsum(n_cells)[:-1]])
    local = np.arange(total) - np.repeat(starts, n_cells)
    sx = np.repeat(span[:, 0], n_cells)
    sy = np.repeat(span[:, 1], n_cells)
    bx = lo[tri_of, 0] + local % sx
    by = lo[tri_of, 1] + (local // sx) % sy
    bz = lo[tri_of, 2] + local // (sx * sy)
    mask[bx, by, bz] = True
    return mask


def wake_children_mask(
    prev_coords: np.ndarray,
    prev_dx: float,
    wake_lo: np.ndarray,
    wake_hi: np.ndarray,
    dims: Tuple[int, int, int],
) -> np.ndarray:
    """Children (at the current level) of previous-level blocks overlapping the
    wake box (reference: src/domain.jl:88-112)."""
    mask = np.zeros(dims, bool)
    if len(prev_coords) == 0:
        return mask
    bs_phys = BLOCK_EDGE * prev_dx
    b_lo = prev_coords * bs_phys
    b_hi = (prev_coords + 1) * bs_phys
    overlap = np.all((b_lo <= wake_hi[None, :]) & (b_hi >= wake_lo[None, :]), axis=1)
    par = prev_coords[overlap]
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = par * 2 + np.array([dx, dy, dz])
                ok = np.all(c < np.asarray(dims), axis=1)
                cc = c[ok]
                if len(cc):
                    mask[cc[:, 0], cc[:, 1], cc[:, 2]] = True
    return mask


def prune_orphans(mask: np.ndarray, parent_mask: np.ndarray) -> np.ndarray:
    """Keep only blocks whose parent block exists on the coarser level
    (reference: src/domain.jl:114-127)."""
    dims = mask.shape
    out = np.zeros(dims, bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                sub = mask[dx::2, dy::2, dz::2]
                par = parent_mask[: sub.shape[0], : sub.shape[1], : sub.shape[2]]
                out[dx::2, dy::2, dz::2] = sub & par
    return out


def build_block_pointer(coords: np.ndarray, dims: Tuple[int, int, int]) -> np.ndarray:
    """Dense (Bx, By, Bz) int32 map: block coord -> block id, -1 if inactive."""
    ptr = np.full(dims, -1, np.int32)
    if len(coords):
        ptr[coords[:, 0], coords[:, 1], coords[:, 2]] = np.arange(
            len(coords), dtype=np.int32
        )
    return ptr


def build_neighbor_table(coords: np.ndarray, ptr: np.ndarray) -> np.ndarray:
    """(nb, 27) int32 neighbor block ids; -1 = absent.  Direction index uses
    the same (dx+1)+3(dy+1)+9(dz+1) encoding as the lattice
    (reference: src/domain_topology.jl:135-160)."""
    nb = len(coords)
    dims = np.asarray(ptr.shape)
    table = np.full((nb, 27), -1, np.int32)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                d = (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)
                nc = coords + np.array([dx, dy, dz], np.int32)
                ok = np.all((nc >= 0) & (nc < dims), axis=1)
                table[ok, d] = ptr[nc[ok, 0], nc[ok, 1], nc[ok, 2]]
    return table

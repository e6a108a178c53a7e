"""Nested dense-patch layout: one dense box per refinement level.

The port's own copy of `open_ludwig_tpu/core/patch.py:36-341`
(`PatchLevel`, the `BC_*` face codes and `build_patches`).  Level 1 is the
full wind tunnel, each finer level one tight box around the geometry and
the wake (reference: src/domain.jl:20-280), so streaming is pure shifts and
the refinement interface is dense slab upsampling.  Three differences from
the reference builder:

  - no storage pad: every level is built at its interior (X, Y, Z) and
    `padded` is the interior (the reference pads y to 8 and z to 128 for
    the TPU tile, :276-280);
  - no flat-(y, z) layout (`_use_flat_yz`, :135-183, whose availability
    check imports jax): the port's (27, X, Y, Z) state already is the
    flat (27, X, Y * Z) view, and `ops/engine.py` picks the flat kernel
    (K4) per level in numpy;
  - one device: no x padding for slab sharding.

The fine boxes still grow toward the TPU tile (z to 128, y to 8 cells)
inside their parent-containment bounds: that growth decides which cells
are refined, which is physics, so both packages solve the same boxes.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import CaseConfig
from ..domain.bouzidi import BouzidiData, compute_bouzidi, should_use_bouzidi
from ..domain.fields import sponge_for_cells, wall_distance_dense
from ..domain.voxelize import flood_fill_dense, voxelize_dense
from ..geometry import TriMesh
from ..scaling import DomainParams
from ..spans import span

log = logging.getLogger("open_ludwig_torch")

# face ids: 0 x-min, 1 x-max, 2 y-min, 3 y-max, 4 z-min, 5 z-max
FACE_AXIS = (0, 0, 1, 1, 2, 2)
FACE_SIDE = (0, 1, 0, 1, 0, 1)
# face type codes
BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Z, BC_INTERFACE = range(5)
DOMAIN_FACE_BC = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)


@dataclass
class PatchLevel:
    """One refinement level as a dense box (host-side static data)."""

    level_id: int  # 1-based, 1 = coarsest
    dx: float
    tau: float
    lo: Tuple[int, int, int]  # global cell offset in level-l coordinates
    interior: Tuple[int, int, int]  # (X, Y, Z) simulated cells = array dims
    face_bc: Tuple[int, ...]  # per face: BC_* code
    obstacle: np.ndarray  # (X, Y, Z) bool
    sponge: np.ndarray  # (X, Y, Z) f32
    wall_dist: np.ndarray  # (X, Y, Z) f32
    bouzidi: Optional[BouzidiData] = None

    @property
    def padded(self) -> Tuple[int, int, int]:
        """The array dims: the interior (the port stores no pad)."""
        return self.interior

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.interior))


def box_sponge(lo, interior, dx: float, domain_size, sponge_thickness: float,
               symmetric: bool) -> np.ndarray:
    """The (X, Y, Z) float32 sponge of the box of `interior` cells at `lo`.
    The sponge is a max of 1-D profiles of x, y and z, so the cell centres
    go in as three broadcastable axis vectors, not three whole-box grids."""
    px, py, pz = np.ix_(*((lo[a] + np.arange(n) + 0.5) * dx
                          for a, n in enumerate(interior)))
    return sponge_for_cells(px, py, pz, domain_size, sponge_thickness, symmetric)


def build_patches(
    cfg: CaseConfig, mesh: TriMesh, params: DomainParams
) -> List[PatchLevel]:
    """The levels of `cfg`, each at its interior, on one device (span
    `build.patches`)."""
    with span("build.patches"):
        return _build_levels(cfg, mesh, params)


def _build_levels(
    cfg: CaseConfig, mesh: TriMesh, params: DomainParams
) -> List[PatchLevel]:
    num_levels = params.num_levels
    offset = np.asarray(params.mesh_offset)
    verts_placed = mesh.vertices + offset[None, None, :]
    pmin = verts_placed.reshape(-1, 3).min(axis=0)
    pmax = verts_placed.reshape(-1, 3).max(axis=0)

    # wake box (physical coords), as in the reference (reference: domain.jl:40-54)
    L = params.reference_length
    wk_lo = np.array(
        [
            pmax[0] - 0.1 * L,
            (pmin[1] + pmax[1]) / 2 - (pmax[1] - pmin[1]) * cfg.wake_width_factor / 2,
            (pmin[2] + pmax[2]) / 2 - (pmax[2] - pmin[2]) * cfg.wake_height_factor / 2,
        ]
    )
    wk_hi = np.array(
        [
            pmax[0] + L * cfg.wake_length,
            (pmin[1] + pmax[1]) / 2 + (pmax[1] - pmin[1]) * cfg.wake_width_factor / 2,
            (pmin[2] + pmax[2]) / 2 + (pmax[2] - pmin[2]) * cfg.wake_height_factor / 2,
        ]
    )

    # `margin` counts 8-cell blocks, like the reference's halo margin
    # (reference: domain_topology.jl:54-133); the tight box is the
    # reference-validated default (open_ludwig_tpu/core/patch.py:219-228).
    margin_cells = cfg.refinement_margin * 8  # block margin, in cells

    patches: List[PatchLevel] = []
    prev: Optional[PatchLevel] = None
    for lvl in range(1, num_levels + 1):
        scale = 2 ** (lvl - 1)
        dx = params.dx_coarse / scale
        dom = (params.nx_coarse * scale, params.ny_coarse * scale, params.nz_coarse * scale)

        if lvl == 1:
            lo = np.zeros(3, np.int64)
            hi = np.asarray(dom, np.int64)
        else:
            blo = np.floor(pmin / dx).astype(np.int64) - margin_cells
            bhi = np.ceil(pmax / dx).astype(np.int64) + margin_cells
            if cfg.wake_enabled:
                blo = np.minimum(blo, np.floor(wk_lo / dx).astype(np.int64) - margin_cells // 2)
                bhi = np.maximum(bhi, np.ceil(wk_hi / dx).astype(np.int64) + margin_cells // 2)
            # parent containment: the fine ghost at lo-1 needs parent cells
            # down to (lo-1)//2 - 1, so keep 2+ parent cells of margin unless
            # the face sits on the domain boundary.
            plo = np.asarray(prev.lo, np.int64)
            phi = plo + np.asarray(prev.interior, np.int64)
            blo = np.maximum(blo, 2 * (plo + 2))
            bhi = np.minimum(bhi, 2 * (phi - 2))
            # clip to domain; snap to even so patches stay sibling-aligned
            blo = np.maximum(blo, 0) // 2 * 2
            bhi = np.minimum(bhi, np.asarray(dom, np.int64))
            bhi = (bhi + 1) // 2 * 2
            # grow extents toward the TPU tile as the reference does, z to
            # multiples of 128, y to multiples of 8 (within parent
            # containment bounds): it decides which cells are refined
            lo_bound = np.maximum(2 * (plo + 2), 0) // 2 * 2
            hi_bound = np.minimum(2 * (phi - 2), np.asarray(dom, np.int64))
            hi_bound = hi_bound // 2 * 2
            for ax, tile in ((2, 128), (1, 8)):
                ext = bhi[ax] - blo[ax]
                grow = -(-ext // tile) * tile - ext  # even (ext and tile even)
                g_lo = min(grow // 2, blo[ax] - lo_bound[ax])
                g_lo -= g_lo % 2
                g_hi = min(grow - g_lo, hi_bound[ax] - bhi[ax])
                g_hi -= g_hi % 2
                blo[ax] -= g_lo
                bhi[ax] += g_hi
            lo, hi = blo, bhi

        interior = tuple(int(v) for v in (hi - lo))
        face_bc = []
        for f in range(6):
            ax, side = FACE_AXIS[f], FACE_SIDE[f]
            at_domain = (lo[ax] == 0) if side == 0 else (hi[ax] == dom[ax])
            face_bc.append(DOMAIN_FACE_BC[f] if at_domain or lvl == 1 else BC_INTERFACE)

        # --- static fields over the patch box (dense builders with the
        # vertices shifted into patch-local coordinates) ---
        verts_local = verts_placed - (lo.astype(np.float64) * dx)[None, None, :]
        active = np.ones(interior, bool)
        with span("build.voxelize"):
            obstacle = voxelize_dense(verts_local, dx, interior)
            obstacle = flood_fill_dense(obstacle, active, 0)

        with span("build.sponge"):
            sponge = box_sponge(lo, interior, dx, params.domain_size,
                                cfg.sponge_thickness, cfg.symmetric_analysis)
        if cfg.wall_model_enabled:
            with span("build.wall_distance"):
                wall = wall_distance_dense(obstacle, dx)
        else:
            wall = np.full(interior, 100.0, np.float32)

        bouzidi = None
        if should_use_bouzidi(lvl, num_levels, cfg):
            with span("build.bouzidi"):
                bouzidi = compute_bouzidi(verts_local, dx, interior, active)
            log.info("[Bouzidi] level %d: %d boundary cells", lvl, bouzidi.n_boundary_cells)

        patch = PatchLevel(
            level_id=lvl,
            dx=dx,
            tau=float(params.tau_levels[lvl - 1]),
            lo=tuple(int(v) for v in lo),
            interior=interior,
            face_bc=tuple(face_bc),
            obstacle=obstacle,
            sponge=sponge,
            wall_dist=wall,
            bouzidi=bouzidi,
        )
        log.info("[Patch] level %d: lo=%s interior=%s (%.2fM cells)",
                 lvl, patch.lo, interior, patch.n_cells / 1e6)
        patches.append(patch)
        prev = patch
    return patches

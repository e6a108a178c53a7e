"""Multi-level domain construction for the blocks layout (host preprocessing).

The port's own copy of `open_ludwig_tpu/domain/builder.py`, built on the
port's `voxelize`, `fields`, `bouzidi` and `geometry`; `should_use_bouzidi`
lives in `domain/bouzidi.py`.  Produces per-level host-side geometry (block
topology + static cell fields + Bouzidi data), mirroring the reference
pipeline (reference: src/domain.jl:20-280) with vectorized numpy;
`tests/test_torch_blocks_host.py` holds every field equal to the JAX
package's.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..config import CaseConfig
from ..geometry import TriMesh, load_mesh
from ..scaling import DomainParams, compute_domain_params
from . import topology as topo
from .bouzidi import BouzidiData, compute_bouzidi, should_use_bouzidi
from .fields import sponge_for_cells, wall_distance_dense
from .voxelize import flood_fill_dense, voxelize_dense

log = logging.getLogger("open_ludwig_torch")

BLOCK_EDGE = 8
BLOCK_CELLS = BLOCK_EDGE**3

# local flat cell decomposition: flat = lz*64 + ly*8 + lx
_LFLAT = np.arange(BLOCK_CELLS)
_LX = (_LFLAT % BLOCK_EDGE).astype(np.int64)
_LY = ((_LFLAT // BLOCK_EDGE) % BLOCK_EDGE).astype(np.int64)
_LZ = (_LFLAT // (BLOCK_EDGE * BLOCK_EDGE)).astype(np.int64)


@dataclass
class LevelGeometry:
    """Host-side static data for one refinement level (0-based ids/coords)."""

    level_id: int  # 1-based, 1 = coarsest
    dx: float
    dt: float
    tau: float
    dims: Tuple[int, int, int]  # block grid (Bx, By, Bz) at this level
    coords: np.ndarray  # (nb, 3) int32 active block coords
    block_ptr: np.ndarray  # (Bx, By, Bz) int32, -1 inactive
    neighbor_table: np.ndarray  # (nb, 27) int32, -1 missing
    obstacle: np.ndarray  # (nb, 512) bool
    sponge: np.ndarray  # (nb, 512) float32
    wall_dist: np.ndarray  # (nb, 512) float32
    bouzidi: Optional[BouzidiData]

    @property
    def n_blocks(self) -> int:
        return len(self.coords)

    @property
    def n_cells(self) -> int:
        return self.n_blocks * BLOCK_CELLS

    @property
    def grid_cells(self) -> Tuple[int, int, int]:
        return tuple(d * BLOCK_EDGE for d in self.dims)


def _dense_to_blocks(dense: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Gather a dense (X, Y, Z) field into block-sparse (nb, 512) layout."""
    gx = coords[:, 0, None] * BLOCK_EDGE + _LX[None, :]
    gy = coords[:, 1, None] * BLOCK_EDGE + _LY[None, :]
    gz = coords[:, 2, None] * BLOCK_EDGE + _LZ[None, :]
    return dense[gx, gy, gz]


def _active_cells_dense(coords: np.ndarray, dims) -> np.ndarray:
    # expand block mask to cells via kron-style repeat
    bm = topo.mask_from_blocks(coords, dims)
    return np.repeat(np.repeat(np.repeat(bm, 8, 0), 8, 1), 8, 2)


def build_domain(
    cfg: CaseConfig, mesh: TriMesh, params: DomainParams
) -> List[LevelGeometry]:
    num_levels = params.num_levels
    offset = np.asarray(params.mesh_offset, np.float64)
    verts_placed = mesh.vertices + offset[None, None, :]

    placed_min = np.asarray(params.mesh_min) + offset
    placed_max = np.asarray(params.mesh_max) + offset
    L = params.reference_length
    wake_lo = np.array(
        [
            placed_max[0] - 0.1 * L,
            (placed_min[1] + placed_max[1]) / 2
            - (placed_max[1] - placed_min[1]) * cfg.wake_width_factor / 2,
            (placed_min[2] + placed_max[2]) / 2
            - (placed_max[2] - placed_min[2]) * cfg.wake_height_factor / 2,
        ]
    )
    wake_hi = np.array(
        [
            placed_max[0] + L * cfg.wake_length,
            (placed_min[1] + placed_max[1]) / 2
            + (placed_max[1] - placed_min[1]) * cfg.wake_width_factor / 2,
            (placed_min[2] + placed_max[2]) / 2
            + (placed_max[2] - placed_min[2]) * cfg.wake_height_factor / 2,
        ]
    )

    levels: List[LevelGeometry] = []
    prev_mask: Optional[np.ndarray] = None

    for lvl in range(1, num_levels + 1):
        scale = 2 ** (lvl - 1)
        dx = params.dx_coarse / scale
        dims = (params.bx_max * scale, params.by_max * scale, params.bz_max * scale)

        if lvl == 1:
            mask = np.ones(dims, bool)
        else:
            if cfg.refinement_strategy == "geometry_first":
                mask = topo.geometry_active_mask(mesh, dx, offset, dims)
                if cfg.wake_enabled:
                    mask |= topo.wake_children_mask(
                        levels[-1].coords, levels[-1].dx, wake_lo, wake_hi, dims
                    )
                mask = topo.prune_orphans(mask, prev_mask)
            else:
                # legacy: refine parents that contain obstacle cells, plus wake
                par = levels[-1]
                has_obs = par.obstacle.any(axis=1)
                src = par.coords[has_obs]
                src_mask = topo.mask_from_blocks(src, par.dims)
                if cfg.wake_enabled:
                    src_mask |= _wake_parent_mask(par, wake_lo, wake_hi) & ~src_mask
                mask = np.zeros(dims, bool)
                for dz in (0, 1):
                    for dy in (0, 1):
                        for ddx in (0, 1):
                            mask[ddx::2, dy::2, dz::2] |= src_mask
            mask = topo.add_halo_with_siblings(mask, cfg.refinement_margin)
            mask = topo.ensure_parent_coverage(mask)

        coords = topo.blocks_from_mask(mask)
        block_ptr = topo.build_block_pointer(coords, dims)
        nb_table = topo.build_neighbor_table(coords, block_ptr)

        grid_cells = tuple(d * BLOCK_EDGE for d in dims)
        active_cells = _active_cells_dense(coords, dims)
        obstacle_dense = voxelize_dense(verts_placed, dx, grid_cells) & active_cells
        if coords.size:
            obstacle_dense = flood_fill_dense(
                obstacle_dense, active_cells, int(coords[:, 0].min())
            )
        obstacle = _dense_to_blocks(obstacle_dense, coords)

        # sponge: pure function of cell-center coords, computed block-sparse
        gx = coords[:, 0, None] * BLOCK_EDGE + _LX[None, :]
        gy = coords[:, 1, None] * BLOCK_EDGE + _LY[None, :]
        gz = coords[:, 2, None] * BLOCK_EDGE + _LZ[None, :]
        sponge = sponge_for_cells(
            (gx + 0.5) * dx,
            (gy + 0.5) * dx,
            (gz + 0.5) * dx,
            params.domain_size,
            cfg.sponge_thickness,
            cfg.symmetric_analysis,
        )

        if cfg.wall_model_enabled:
            wd_dense = wall_distance_dense(obstacle_dense, dx)
            wall_dist = _dense_to_blocks(wd_dense, coords)
            del wd_dense
        else:
            wall_dist = np.full((len(coords), BLOCK_CELLS), 100.0, np.float32)

        bouzidi = None
        if should_use_bouzidi(lvl, num_levels, cfg):
            bouzidi = compute_bouzidi(verts_placed, dx, grid_cells, active_cells)
            log.info(
                "[Bouzidi] level %d: %d boundary cells", lvl, bouzidi.n_boundary_cells
            )
        del obstacle_dense, active_cells

        levels.append(
            LevelGeometry(
                level_id=lvl,
                dx=dx,
                dt=1.0 / scale,
                tau=float(params.tau_levels[lvl - 1]),
                dims=dims,
                coords=coords,
                block_ptr=block_ptr,
                neighbor_table=nb_table,
                obstacle=obstacle,
                sponge=sponge,
                wall_dist=wall_dist,
                bouzidi=bouzidi,
            )
        )
        log.info(
            "[Domain] level %d: %d blocks, %.2fM cells, dx=%.5g",
            lvl,
            len(coords),
            len(coords) * BLOCK_CELLS / 1e6,
            dx,
        )
        prev_mask = mask

    verify_parent_coverage(levels)
    return levels


def _wake_parent_mask(par: LevelGeometry, wake_lo, wake_hi) -> np.ndarray:
    bs_phys = BLOCK_EDGE * par.dx
    b_lo = par.coords * bs_phys
    b_hi = (par.coords + 1) * bs_phys
    overlap = np.all((b_lo <= wake_hi[None, :]) & (b_hi >= wake_lo[None, :]), axis=1)
    return topo.mask_from_blocks(par.coords[overlap], par.dims)


def verify_parent_coverage(levels: List[LevelGeometry]) -> List[int]:
    """Count fine blocks without an active parent per level
    (reference: src/domain.jl:249-263)."""
    missing = []
    for i in range(1, len(levels)):
        fine = levels[i]
        coarse_mask = topo.mask_from_blocks(levels[i - 1].coords, levels[i - 1].dims)
        par = fine.coords // 2
        miss = int((~coarse_mask[par[:, 0], par[:, 1], par[:, 2]]).sum())
        missing.append(miss)
        if miss:
            log.warning("[Verify] level %d: %d blocks missing parents", i + 1, miss)
    return missing


def setup_case(cfg: CaseConfig):
    """Load mesh, size the domain, and build all levels.

    Returns (mesh, params, levels)."""
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_domain(cfg, mesh, params)
    return mesh, params, levels

"""Static streaming/boundary plans of the blocks layout.

The port's own copy of `open_ludwig_tpu/core/plan.py`: the same numpy
arrays, int32 as there (`tests/test_torch_blocks_host.py`);
`core.state._plan_to_device` moves them to the device as int64.

The whole block topology, boundary classification, refinement-interface
interpolation geometry, and Bouzidi link lists are STATIC for a run.  We
therefore compile them once (host-side numpy) into flat gather/scatter index
plans; the runtime step is then pure dense array math + a handful of gathers
and one static-index scatter per level — no data-dependent control flow, which
is what a static gather/scatter step wants.

Index spaces
------------
- f space:    idx = (k * nb + b) * 512 + cell      for f of shape (27, nb, 512)
- cell space: idx = b * 512 + cell                  for rho/vel/obstacle/...
- cell:       local flat = lz*64 + ly*8 + lx        within an 8^3 block

Pull streaming is a per-direction roll on the flat cell axis; every (k, cell)
whose source leaves the block gets a "fixup" classified exactly like the
reference kernel's boundary branch (reference: src/physics_kernels.jl:62-149):
neighbor-block gather, inlet equilibrium + hash noise, outlet equilibrium,
y/z mirror, coarse-parent interpolation, or the w_k fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .. import lattice as lat
from ..domain.builder import LevelGeometry

BLOCK_EDGE = 8
BLOCK_CELLS = 512

# BC category codes for fixup pairs
GATHER, INLET, OUTLET, PARENT, CONST = range(5)

_LFLAT = np.arange(BLOCK_CELLS)
_LX = _LFLAT % 8
_LY = (_LFLAT // 8) % 8
_LZ = _LFLAT // 64


def _crossing_template(k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Local cells whose pull source (cell - c_k) leaves the block, and the
    per-axis source coords (unwrapped, may be -1 or 8)."""
    cx, cy, cz = lat.C_X[k], lat.C_Y[k], lat.C_Z[k]
    sx, sy, sz = _LX - cx, _LY - cy, _LZ - cz
    cross = (sx < 0) | (sx > 7) | (sy < 0) | (sy > 7) | (sz < 0) | (sz > 7)
    cells = _LFLAT[cross]
    return cells, sx[cross], sy[cross], sz[cross]


@dataclass
class StreamPlan:
    """Numpy-side plan for one level; converted to device arrays by the state
    initializer.  All *_dst indices are unique; `scatter_dst` is pre-sorted and
    `scatter_perm` reorders the concatenated category values to match."""

    nb: int
    # rolled-streaming fixups ------------------------------------------------
    scatter_dst: np.ndarray  # (n_fix,) int32 into f space, sorted
    scatter_perm: np.ndarray  # (n_fix,) int32 permutation of concatenated values
    gather_src: np.ndarray  # (ng,) int32 into f space
    inlet_k: np.ndarray  # (ni,) int32
    inlet_gy: np.ndarray  # (ni,) int32 1-based dst cell gy (noise seed parity)
    inlet_gz: np.ndarray  # (ni,) int32
    outlet_k: np.ndarray  # (no,) int32
    const_val: np.ndarray  # (nc,) float32
    # parent interpolation pairs ---------------------------------------------
    parent_k: np.ndarray  # (np,) int32
    parent_idx: np.ndarray  # (np, 8) int32 into parent cell space (0 if invalid)
    parent_valid: np.ndarray  # (np, 8) bool
    parent_w: np.ndarray  # (np, 3) float32 (wx, wy, wz)
    fneq_rescale: float  # clamp((tau_f-0.5)/(tau_c-0.5), 0.01, 100)
    # velocity-gradient neighbor fixups (6 face dirs) ------------------------
    vel_dst: Tuple[np.ndarray, ...]  # per face dir: (nv,) int32 cell space
    vel_src: Tuple[np.ndarray, ...]  # per face dir: (nv,) int32 cell space
    # category sizes for runtime concat order [gather, inlet, outlet, const, parent]
    sizes: Tuple[int, int, int, int, int] = (0, 0, 0, 0, 0)


# face-dir offsets in the order used by the gradient computation:
# E(+x), W(-x), N(+y), S(-y), T(+z), B(-z)  (reference: src/physics_utils.jl:72-83)
FACE_DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
FACE_ROLL = tuple(-(dz * 64 + dy * 8 + dx) for dx, dy, dz in FACE_DIRS)


def build_stream_plan(
    geo: LevelGeometry,
    parent: Optional[LevelGeometry],
    tau_parent: float,
    nx_g: int,
    ny_g: int,
    nz_g: int,
) -> StreamPlan:
    """nx_g/ny_g/nz_g: global cell dims of the *simulated* domain at this
    level's resolution (domain_n * 2^(lvl-1)); may be smaller than the block
    grid since the coarse grid is rounded up to block multiples."""
    nb = geo.n_blocks
    coords = geo.coords.astype(np.int64)
    nbr = geo.neighbor_table.astype(np.int64)

    g_dst, g_src = [], []
    i_dst, i_k, i_gy, i_gz = [], [], [], []
    o_dst, o_k = [], []
    c_dst, c_val = [], []
    p_dst, p_k, p_idx, p_valid, p_w = [], [], [], [], []

    is_level1 = parent is None

    for k in range(27):
        if k == 13:
            continue
        cells, sx, sy, sz = _crossing_template(k)
        if len(cells) == 0:
            continue
        ncell = len(cells)
        # neighbor direction per template cell (same for all blocks)
        offx = np.where(sx < 0, -1, np.where(sx > 7, 1, 0))
        offy = np.where(sy < 0, -1, np.where(sy > 7, 1, 0))
        offz = np.where(sz < 0, -1, np.where(sz > 7, 1, 0))
        d = (offx + 1) + 3 * (offy + 1) + 9 * (offz + 1)
        wrap = (sz % 8) * 64 + (sy % 8) * 8 + (sx % 8)

        nb_id = nbr[:, d]  # (nb, ncell)
        dst = ((k * nb + np.arange(nb)[:, None]) * BLOCK_CELLS + cells[None, :]).astype(
            np.int64
        )

        has_nbr = nb_id >= 0
        # gather category: neighbor block exists
        src = (k * nb + nb_id) * BLOCK_CELLS + wrap[None, :]
        g_dst.append(dst[has_nbr])
        g_src.append(src[has_nbr])

        # missing neighbor: classify by global source coords
        miss = ~has_nbr
        if miss.any():
            bsel, csel = np.nonzero(miss)
            gx = coords[bsel, 0] * 8 + _LX[cells[csel]]
            gy = coords[bsel, 1] * 8 + _LY[cells[csel]]
            gz = coords[bsel, 2] * 8 + _LZ[cells[csel]]
            sgx = gx - lat.C_X[k]
            sgy = gy - lat.C_Y[k]
            sgz = gz - lat.C_Z[k]
            dmiss = dst[miss]

            inlet = sgx < 0
            outlet = ~inlet & (sgx >= nx_g)
            ymir = ~inlet & ~outlet & ((sgy < 0) | (sgy >= ny_g))
            zmir = ~inlet & ~outlet & ~ymir & ((sgz < 0) | (sgz >= nz_g))
            rest = ~(inlet | outlet | ymir | zmir)

            if inlet.any():
                i_dst.append(dmiss[inlet])
                i_k.append(np.full(inlet.sum(), k, np.int32))
                i_gy.append((gy[inlet] + 1).astype(np.int32))  # 1-based, reference hash
                i_gz.append((gz[inlet] + 1).astype(np.int32))
            if outlet.any():
                o_dst.append(dmiss[outlet])
                o_k.append(np.full(outlet.sum(), k, np.int32))
            # mirrors gather the own cell's mirrored distribution
            for mir, mk in ((ymir, lat.MIRROR_Y[k]), (zmir, lat.MIRROR_Z[k])):
                if mir.any():
                    own = bsel[mir] * BLOCK_CELLS + cells[csel[mir]]
                    g_dst.append(dmiss[mir])
                    g_src.append(mk * nb * BLOCK_CELLS + own)
            if rest.any():
                if is_level1:
                    c_dst.append(dmiss[rest])
                    c_val.append(np.full(rest.sum(), lat.W[k], np.float32))
                else:
                    idx8, val8, w3 = _parent_interp_geometry(
                        sgx[rest], sgy[rest], sgz[rest], parent
                    )
                    p_dst.append(dmiss[rest])
                    p_k.append(np.full(rest.sum(), k, np.int32))
                    p_idx.append(idx8)
                    p_valid.append(val8)
                    p_w.append(w3)

    def _cat(lst, dtype=np.int32, width=None):
        if not lst:
            if width is None:
                return np.zeros(0, dtype)
            return np.zeros((0, width), dtype)
        return np.concatenate(lst).astype(dtype)

    gather_dst = _cat(g_dst)
    gather_src = _cat(g_src)
    inlet_dst = _cat(i_dst)
    outlet_dst = _cat(o_dst)
    const_dst = _cat(c_dst)
    parent_dst = _cat(p_dst)

    all_dst = np.concatenate([gather_dst, inlet_dst, outlet_dst, const_dst, parent_dst])
    order = np.argsort(all_dst, kind="stable")
    scatter_dst = all_dst[order].astype(np.int32)
    scatter_perm = order.astype(np.int32)

    if parent is not None:
        tc = tau_parent - 0.5
        tf = geo.tau - 0.5
        rescale = float(np.clip(tf / tc, 0.01, 100.0)) if tc > 1e-6 else 1.0
    else:
        rescale = 1.0

    # velocity-gradient fixups per face dir
    vel_dst, vel_src = [], []
    for dx, dy, dz in FACE_DIRS:
        nxl, nyl, nzl = _LX + dx, _LY + dy, _LZ + dz
        cross = (nxl < 0) | (nxl > 7) | (nyl < 0) | (nyl > 7) | (nzl < 0) | (nzl > 7)
        cells = _LFLAT[cross]
        d = (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)
        wrap = (nzl[cross] % 8) * 64 + (nyl[cross] % 8) * 8 + (nxl[cross] % 8)
        nb_id = nbr[:, d]  # (nb,)
        dst = (np.arange(nb)[:, None] * BLOCK_CELLS + cells[None, :]).astype(np.int64)
        own = (np.arange(nb)[:, None] * BLOCK_CELLS + cells[None, :]).astype(np.int64)
        src = np.where(
            nb_id[:, None] >= 0, nb_id[:, None] * BLOCK_CELLS + wrap[None, :], own
        )
        vel_dst.append(dst.ravel().astype(np.int32))
        vel_src.append(src.ravel().astype(np.int32))

    return StreamPlan(
        nb=nb,
        scatter_dst=scatter_dst,
        scatter_perm=scatter_perm,
        gather_src=gather_src.astype(np.int32),
        inlet_k=_cat(i_k),
        inlet_gy=_cat(i_gy),
        inlet_gz=_cat(i_gz),
        outlet_k=_cat(o_k),
        const_val=_cat(c_val, np.float32),
        parent_k=_cat(p_k),
        parent_idx=np.concatenate(p_idx).astype(np.int32)
        if p_idx
        else np.zeros((0, 8), np.int32),
        parent_valid=np.concatenate(p_valid)
        if p_valid
        else np.zeros((0, 8), bool),
        parent_w=np.concatenate(p_w).astype(np.float32)
        if p_w
        else np.zeros((0, 3), np.float32),
        fneq_rescale=rescale,
        vel_dst=tuple(vel_dst),
        vel_src=tuple(vel_src),
        sizes=(
            len(gather_dst),
            len(inlet_dst),
            len(outlet_dst),
            len(const_dst),
            len(parent_dst),
        ),
    )


def _parent_interp_geometry(sgx, sgy, sgz, parent: LevelGeometry):
    """Trilinear corner indices/validity/weights into the parent level for
    fine source cells at 0-based global coords (sgx, sgy, sgz)
    (reference: src/physics_interpolation.jl:28-47).

    Mirrors the reference's 1-based arithmetic: continuous parent coordinate
    p = (g_1b - 0.5) * 0.5, lower corner floor(p) with weights from the
    UNclamped floor, then a low clamp at parent cell 1 (1-based)."""
    n = len(sgx)
    ptr = parent.block_ptr
    dims = np.asarray(ptr.shape)

    p_cont = np.stack(
        [(sgx + 1 - 0.5) * 0.5, (sgy + 1 - 0.5) * 0.5, (sgz + 1 - 0.5) * 0.5], axis=1
    )
    p0 = np.floor(p_cont).astype(np.int64)  # 1-based parent cell of low corner
    w = (p_cont - p0).astype(np.float32)
    p0c = np.maximum(1, p0)  # low clamp only, like the reference

    # corner coords follow the reference exactly: low corner = clamped p0,
    # high corner = UNclamped p0 + 1 (px1 is computed before the clamp)
    idx8 = np.zeros((n, 8), np.int64)
    val8 = np.zeros((n, 8), bool)
    corner = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                pgx = np.where(dx == 0, p0c[:, 0], p0[:, 0] + 1)
                pgy = np.where(dy == 0, p0c[:, 1], p0[:, 1] + 1)
                pgz = np.where(dz == 0, p0c[:, 2], p0[:, 2] + 1)
                g0 = np.stack([pgx, pgy, pgz], axis=1) - 1  # to 0-based cells
                blk = g0 // 8
                inb = np.all((blk >= 0) & (blk < dims[None, :]), axis=1)
                bid = np.full(n, -1, np.int64)
                bsafe = np.clip(blk, 0, dims[None, :] - 1)
                bid[inb] = ptr[bsafe[inb, 0], bsafe[inb, 1], bsafe[inb, 2]]
                ok = inb & (bid >= 0)
                loc = g0 % 8
                flat = loc[:, 2] * 64 + loc[:, 1] * 8 + loc[:, 0]
                idx8[:, corner] = np.where(ok, bid * BLOCK_CELLS + flat, 0)
                val8[:, corner] = ok
                corner += 1
    return idx8, val8, w


@dataclass
class BouzidiPlan:
    """Static link lists for the Bouzidi second-order wall correction
    (reference: src/bouzidi_kernel.jl:13-92).  Applied as
    f_out[dst] = a * f_out[src_k] + b * f_out[src_other] on the uncorrected
    post-collision field (functional form needs no separate f_post buffer)."""

    dst: np.ndarray  # (nl,) int32 f-space, unique
    src_k: np.ndarray  # (nl,) int32 f-space
    src_other: np.ndarray  # (nl,) int32 f-space (x_ff for q<0.5 else own opp)
    coef_a: np.ndarray  # (nl,) float32
    coef_b: np.ndarray  # (nl,) float32


def build_bouzidi_plan(geo: LevelGeometry, q_min: float) -> Optional[BouzidiPlan]:
    bz = geo.bouzidi
    if bz is None or bz.n_boundary_cells == 0:
        return None
    nb = geo.n_blocks
    ptr = geo.block_ptr
    nbr = geo.neighbor_table.astype(np.int64)

    blk = np.stack([bz.cell_gx // 8, bz.cell_gy // 8, bz.cell_gz // 8], axis=1)
    bid = ptr[blk[:, 0], blk[:, 1], blk[:, 2]].astype(np.int64)
    lx, ly, lz = bz.cell_gx % 8, bz.cell_gy % 8, bz.cell_gz % 8
    flat = (lz * 64 + ly * 8 + lx).astype(np.int64)

    # q as float32-of-float16, matching the reference's storage rounding
    q = bz.q_map.astype(np.float32)  # (nc, 27)

    dst, src_k_l, src_o, ca, cb = [], [], [], [], []
    for k in range(27):
        if k == 13:
            continue
        qv = q[:, k]
        act = (qv > q_min) & (qv <= 1.0)
        if not act.any():
            continue
        sel = np.nonzero(act)[0]
        qs = qv[sel]
        b = bid[sel]
        c = flat[sel]
        opp_k = lat.OPP[k]
        dst.append((opp_k * nb + b) * BLOCK_CELLS + c)
        src_k_l.append((k * nb + b) * BLOCK_CELLS + c)

        lo = qs < 0.5
        # q >= 0.5 branch: other = own opp post-collision value
        other_hi = (opp_k * nb + b) * BLOCK_CELLS + c
        # q < 0.5 branch: other = f_k at x_ff = cell + c_opp (i.e. cell - c_k)
        nx = lx[sel] + lat.C_X[opp_k]
        ny = ly[sel] + lat.C_Y[opp_k]
        nz = lz[sel] + lat.C_Z[opp_k]
        inside = (nx >= 0) & (nx < 8) & (ny >= 0) & (ny < 8) & (nz >= 0) & (nz < 8)
        offx = np.where(nx < 0, -1, np.where(nx > 7, 1, 0))
        offy = np.where(ny < 0, -1, np.where(ny > 7, 1, 0))
        offz = np.where(nz < 0, -1, np.where(nz > 7, 1, 0))
        d = (offx + 1) + 3 * (offy + 1) + 9 * (offz + 1)
        nb_id = nbr[b, d]
        wrap = (nz % 8) * 64 + (ny % 8) * 8 + (nx % 8)
        ff_b = np.where(inside, b, nb_id)
        ff_flat = np.where(inside, nz * 64 + ny * 8 + nx, wrap)
        have_ff = ff_b >= 0
        other_lo = np.where(
            have_ff,
            (k * nb + np.maximum(ff_b, 0)) * BLOCK_CELLS + ff_flat,
            (k * nb + b) * BLOCK_CELLS + c,  # fallback f_ff = f_k
        )
        src_o.append(np.where(lo, other_lo, other_hi))
        a = np.where(lo, 2.0 * qs, 1.0 / (2.0 * qs))
        bcoef = np.where(lo, 1.0 - 2.0 * qs, (2.0 * qs - 1.0) / (2.0 * qs))
        ca.append(a.astype(np.float32))
        cb.append(bcoef.astype(np.float32))

    if not dst:
        return None
    return BouzidiPlan(
        dst=np.concatenate(dst).astype(np.int32),
        src_k=np.concatenate(src_k_l).astype(np.int32),
        src_other=np.concatenate(src_o).astype(np.int32),
        coef_a=np.concatenate(ca),
        coef_b=np.concatenate(cb),
    )

"""Aerodynamic forces on the finest level: surface-stress mapping and
momentum exchange.

Port of `open_ludwig_tpu/ops/forces.py`: the stress-mapping path
(`build_triangle_cell_map_dense`, `_second_sample`,
`make_force_context_dense`, `_surface_stresses`, `compute_aerodynamics`;
for the blocks layout `build_triangle_cell_map`, `_report_coverage` and
`make_force_context`, whose cell indices are b * 512 + local, so
`compute_aerodynamics` serves both layouts) and the momentum-exchange
method of the patch layout (`MEMContext`, `make_mem_context`,
`compute_aerodynamics_mem`; see `MEMContext`).
Each STL triangle is mapped once, in numpy, to its nearest fluid cell
(expanding-shell semantics, reference: src/forces/surface.jl:138-266);
each evaluation gathers (rho, vel) at the mapped cells and integrates

  p    = (rho - 1)/3 * rho_phys * velocity_scale^2
  tau  = rho * nu_lat * |u_t| / dist   (same scale), along u_t
  dF_p = -p n A,  dF_v = tau A,  dM = r x dF about the moment center

with symmetry doubling of Fx/Fz/My and zeroing of Fy/Mx/Mz for half
models (reference: src/forces/surface.jl:282-366, :517-526).  A patch
level's cell indices are flat in the port's unpadded (X, Y, Z) strides.

On a card `compute_aerodynamics` runs the stress map as a CUDA graph
(`ForceGraphs`, one per `ForceContext`): the same operations in the same
order, whose last node packs the five results (Fp, Fv, M, p, tau_vec)
into one float64 vector (`pack`), read back in one blocking copy and
unpacked on the host (`unpack`; float32 -> float64 -> float32 is exact,
so every sum and map is bit-equal to the eager evaluation).  A graph is
keyed on the finest level's rho and vel as the code sees them (`graph_key`:
device, address, shape, stride, dtype); it reads the caller's tensors at
their addresses, never a copy.  A context holds at most `ForceGraphs.LIMIT`
graphs; a caller that hands in new tensors past that is evaluated eagerly,
still with one read-back.  On the CPU the map runs eagerly and its five
results come back in five copies (`eager_sums`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .. import graphs
from ..geometry import TriMesh
from ..scaling import DomainParams
from ..spans import count, span

log = logging.getLogger("open_ludwig_torch")


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


def build_triangle_cell_map(
    mesh: TriMesh,
    geo,
    params: DomainParams,
    search_radius: int = 5,
    chunk: int = 4096,
) -> Dict[str, np.ndarray]:
    """For each triangle: nearest fluid cell (expanding-shell semantics:
    scan shells outward, stop one shell after the first hit, keep the
    minimum-distance candidate) and the wall distance in lattice units, on
    the finest level `geo` (a `domain.builder.LevelGeometry`) of the blocks
    layout: flat cell indices b * 512 + local."""
    dx = geo.dx
    offset = np.asarray(params.mesh_offset)
    centers = mesh.centers + offset[None, :]  # domain coords
    n_tri = len(centers)
    dims_cells = np.asarray(geo.grid_cells)

    # dense obstacle/active lookup for the finest level
    obstacle_d = np.ones(tuple(dims_cells), bool)  # inactive treated as non-fluid
    lf = np.arange(512)
    lx, ly, lz = lf % 8, (lf // 8) % 8, lf // 64
    gx = geo.coords[:, 0, None] * 8 + lx[None, :]
    gy = geo.coords[:, 1, None] * 8 + ly[None, :]
    gz = geo.coords[:, 2, None] * 8 + lz[None, :]
    obstacle_d[gx, gy, gz] = geo.obstacle
    block_ptr = geo.block_ptr

    # offsets ordered by Chebyshev shell radius
    r = search_radius
    off = np.stack(
        np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), np.arange(-r, r + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    shell = np.abs(off).max(axis=1)
    order = np.argsort(shell, kind="stable")
    off = off[order]
    shell = shell[order]

    cell_idx = np.full(n_tri, -1, np.int64)  # flat cell index b*512 + local
    wall_dist = np.full(n_tri, 0.5, np.float64)
    found = np.zeros(n_tri, bool)
    cell_idx2 = np.zeros(n_tri, np.int64)
    found2 = np.zeros(n_tri, bool)
    dn1 = np.full(n_tri, 0.5, np.float64)
    dn2 = np.full(n_tri, 1.5, np.float64)

    def blk_flat(bc):
        blk = bc // 8
        bid = block_ptr[blk[:, 0], blk[:, 1], blk[:, 2]].astype(np.int64)
        loc = bc % 8
        return bid * 512 + loc[:, 2] * 64 + loc[:, 1] * 8 + loc[:, 0]

    for s in range(0, n_tri, chunk):
        e = min(s + chunk, n_tri)
        tc = centers[s:e]
        # anchor cell: reference uses floor(t/dx)+1 in 1-based = floor(t/dx) 0-based
        g0 = np.floor(tc / dx).astype(np.int64)  # (m, 3)
        cand = g0[:, None, :] + off[None, :, :]  # (m, no, 3)
        valid = np.all((cand >= 0) & (cand < dims_cells[None, None, :]), axis=2)
        cc = np.clip(cand, 0, dims_cells - 1)
        fluid = valid & ~obstacle_d[cc[..., 0], cc[..., 1], cc[..., 2]]
        cell_cent = (cand + 0.5) * dx
        d2 = np.sum((cell_cent - tc[:, None, :]) ** 2, axis=2)
        d2 = np.where(fluid, d2, np.inf)
        # shell-limited search: allowed shells <= first_hit_shell + 1
        first_shell = np.where(
            fluid.any(axis=1), shell[np.argmax(fluid, axis=1)], r + 1
        )
        allowed = shell[None, :] <= np.minimum(first_shell + 1, r)[:, None]
        d2 = np.where(allowed, d2, np.inf)
        best = np.argmin(d2, axis=1)
        has = np.isfinite(d2[np.arange(len(best)), best])
        bc = cc[np.arange(len(best)), best]  # (m, 3) best cell coords
        cell_idx[s:e] = np.where(has, blk_flat(bc), 0)
        found[s:e] = has
        wd = np.sqrt(d2[np.arange(len(best)), best]) / dx
        wall_dist[s:e] = np.where(has, np.maximum(wd, 0.5), 0.5)

        bc2, has2, d1n, d2n = _second_sample(
            tc, mesh.normals[s:e], bc, has, dx, dims_cells,
            lambda cc_: ~obstacle_d[cc_[..., 0], cc_[..., 1], cc_[..., 2]],
        )
        cell_idx2[s:e] = np.where(has2, blk_flat(bc2), 0)
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


@dataclass
class ForceContext:
    """Device-side constants for force evaluation."""

    cell_idx: torch.Tensor  # (n_tri,) int64
    wall_dist: torch.Tensor  # (n_tri,) lattice units
    found: torch.Tensor  # (n_tri,) bool
    normals: torch.Tensor  # (3, n_tri)
    areas: torch.Tensor  # (n_tri,)
    centers: torch.Tensor  # (3, n_tri) in domain coords (offset applied)
    moment_center: torch.Tensor  # (3,)
    tau_molecular: float
    pressure_scale: float
    q_inf: float
    area_ref: float
    chord_ref: float
    symmetric: bool
    cell_idx2: torch.Tensor  # (n_tri,) second (wall-normal) sample
    found2: torch.Tensor
    dn1: torch.Tensor
    dn2: torch.Tensor
    extrapolate: bool = False
    # the stress map's graphs on a card; a new context (`dataclasses.replace`
    # too) starts with none, as its constants lie at other addresses
    graphs: "ForceGraphs" = field(default_factory=lambda: ForceGraphs(), init=False,
                                  repr=False, compare=False)

    @property
    def n_tri(self) -> int:
        return int(self.cell_idx.shape[0])


@dataclass
class ForceResult:
    Fx: float = 0.0
    Fy: float = 0.0
    Fz: float = 0.0
    Fx_pressure: float = 0.0
    Fy_pressure: float = 0.0
    Fz_pressure: float = 0.0
    Fx_viscous: float = 0.0
    Fy_viscous: float = 0.0
    Fz_viscous: float = 0.0
    Mx: float = 0.0
    My: float = 0.0
    Mz: float = 0.0
    Cd: float = 0.0
    Cl: float = 0.0
    Cs: float = 0.0
    Cmx: float = 0.0
    Cmy: float = 0.0
    Cmz: float = 0.0
    pressure_map: np.ndarray = None  # (n_tri,) Pa
    shear_map: np.ndarray = None  # (3, n_tri) Pa
    force_map: np.ndarray = None  # (3, n_tri) N, momentum-exchange only


def make_force_context_dense(
    mesh: TriMesh, patch, params: DomainParams, search_radius: int = 5,
    extrapolate: bool = True, device="cpu",
) -> ForceContext:
    with span("build.force_context"):
        m = build_triangle_cell_map_dense(mesh, patch, params, search_radius)
        _report_coverage(m["found"], "patch layout")
        return _force_context(m, mesh, patch.tau, params, extrapolate, device)


def make_force_context(
    mesh: TriMesh, geo, params: DomainParams, search_radius: int = 5,
    extrapolate: bool = True, device="cpu",
) -> ForceContext:
    """The force context of the blocks layout's finest level `geo`."""
    m = build_triangle_cell_map(mesh, geo, params, search_radius)
    _report_coverage(m["found"], "blocks layout")
    return _force_context(m, mesh, geo.tau, params, extrapolate, device)


def _report_coverage(found: np.ndarray, what: str) -> None:
    """Stress-mapping coverage diagnostics, mirroring the reference's
    mapped/total triangle statistics (reference: forces/surface.jl:425-445)."""
    n, ok = int(found.size), int(np.count_nonzero(found))
    log.info("[Forces] stress mapping (%s): %d/%d triangles mapped (%.1f%%)",
             what, ok, n, 100.0 * ok / max(n, 1))
    if ok < n:
        log.warning("[Forces] %d triangles found no nearby fluid cell; their "
                    "pressure/shear contribution is zero", n - ok)


def _force_context(m: Dict[str, np.ndarray], mesh: TriMesh, tau: float,
                   params: DomainParams, extrapolate: bool, device) -> ForceContext:
    """A triangle -> cell map on `device` with the case's constants."""
    offset = np.asarray(params.mesh_offset)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ForceContext(
        cell_idx=t(m["cell_idx"], torch.int64),
        wall_dist=t(m["wall_dist"]),
        found=t(m["found"], torch.bool),
        normals=t(mesh.normals.T.astype(np.float32)),
        areas=t(mesh.areas.astype(np.float32)),
        centers=t((mesh.centers + offset).T.astype(np.float32)),
        moment_center=t(np.asarray(params.moment_center, np.float32)),
        tau_molecular=float(tau),
        pressure_scale=float(params.rho_physical * params.velocity_scale**2),
        q_inf=float(0.5 * params.rho_physical * params.u_physical**2),
        area_ref=float(params.reference_area),
        chord_ref=float(params.reference_chord),
        symmetric=bool(params.symmetric),
        cell_idx2=t(m["cell_idx2"], torch.int64),
        found2=t(m["found2"], torch.bool),
        dn1=t(m["dn1"]),
        dn2=t(m["dn2"]),
        extrapolate=extrapolate,
    )


def _surface_stresses(rho_flat, vel_flat, ctx: ForceContext):
    rho_c = rho_flat[ctx.cell_idx]
    u_c = vel_flat[:, ctx.cell_idx]  # (3, n)
    normals = ctx.normals
    p = (rho_c - 1.0) / 3.0 * ctx.pressure_scale
    if ctx.extrapolate:
        # linear extrapolation to the wall along the outward normal, factor
        # clamped (noise amplification), plain sample without a second cell
        p2 = (rho_flat[ctx.cell_idx2] - 1.0) / 3.0 * ctx.pressure_scale
        fac = torch.clamp(ctx.dn1 / torch.clamp(ctx.dn2 - ctx.dn1, min=0.25),
                          0.0, 2.0)
        p = torch.where(ctx.found2, p + (p - p2) * fac, p)
    u_dot_n = (u_c * normals).sum(dim=0)
    ut = u_c - u_dot_n[None, :] * normals
    ut_mag = torch.sqrt((ut * ut).sum(dim=0))
    nu_lat = (ctx.tau_molecular - 0.5) / 3.0
    shear_ok = (ut_mag > 1e-10) & (ctx.wall_dist > 0.01)
    tau_mag = (rho_c * nu_lat * ut_mag / torch.clamp(ctx.wall_dist, min=0.01)
               * ctx.pressure_scale)
    tau_vec = torch.where(
        shear_ok[None, :],
        ut / torch.clamp(ut_mag, min=1e-20)[None, :] * tau_mag,
        torch.zeros_like(ut),
    )
    p = torch.where(ctx.found, p, torch.zeros_like(p))
    tau_vec = torch.where(ctx.found[None, :], tau_vec, torch.zeros_like(tau_vec))

    dFp = -p[None, :] * normals * ctx.areas[None, :]  # (3, n)
    dFv = tau_vec * ctx.areas[None, :]
    dF = dFp + dFv
    rvec = ctx.centers - ctx.moment_center[:, None]
    dM = torch.linalg.cross(rvec, dF, dim=0)  # (3, n)
    return p, tau_vec, dFp.sum(dim=1), dFv.sum(dim=1), dM.sum(dim=1)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """`t` on the host: a blocking copy, counted as `sync.forces`."""
    count("sync.forces")
    return t.cpu().numpy()


Sums = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def pack(p, tau_vec, Fp, Fv, M) -> torch.Tensor:
    """The stress map's results as one float64 vector: Fp, Fv, M (3 each),
    p (n_tri), tau_vec (3 x n_tri, row by row)."""
    return torch.cat((Fp, Fv, M, p, tau_vec.reshape(-1))).double()


def unpack(buf: np.ndarray, n_tri: int) -> Sums:
    """`pack`'s vector on the host: (Fp, Fv, M) in float64, (p, tau_vec) in
    float32 as the map computed them."""
    maps = buf[9:].astype(np.float32)
    return buf[0:3], buf[3:6], buf[6:9], maps[:n_tri], maps[n_tri:].reshape(3, n_tri)


def _packed(rho, vel, ctx: ForceContext) -> torch.Tensor:
    return pack(*_surface_stresses(rho.reshape(-1), vel.reshape(3, -1), ctx))


def eager_sums(rho, vel, ctx: ForceContext) -> Sums:
    """The stress map's launches (span `forces.map`) and its five results
    copied to the host one by one (`forces.readback`): (Fp, Fv, M, p,
    tau_vec), the path on the CPU."""
    with span("forces.map"):
        p, tau_vec, Fp, Fv, M = _surface_stresses(rho.reshape(-1), vel.reshape(3, -1), ctx)
        Fp, Fv, M = Fp.double(), Fv.double(), M.double()
    with span("forces.readback"):
        return tuple(_fetch(t) for t in (Fp, Fv, M, p, tau_vec))


def graph_key(rho: torch.Tensor, vel: torch.Tensor) -> Hashable:
    """What a graph of the stress map depends on in its inputs: each
    tensor's device, address, shape, stride and dtype."""
    return tuple((t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in (rho, vel))


class ForceGraphs:
    """The stress map of one `ForceContext` as CUDA graphs, by `graph_key`.

    A key's first evaluation runs the map once on a side stream (the
    warm-up before a capture: library loads, the allocator's blocks),
    captures it under `graphs.no_host_sync` into a pool the context's
    graphs share, and replays it (span `forces.capture`, counter
    `forces.capture`); its later evaluations replay it (`forces.replay`,
    `forces.graph`).  Past `LIMIT` keys the map runs eagerly (counter
    `forces.eager`), so a caller that hands in new tensors each time pays
    no capture a sample.  The replays count apart from the step graphs'
    (`graphs.GraphSet`): nothing of `graph.ops` / `graph.steps`."""

    LIMIT = 2

    def __init__(self):
        self.graphs: Dict[Hashable, Tuple[object, torch.Tensor]] = {}
        self.pool = None
        self.pool_bytes = 0  # the allocator's segments in the graphs' pool

    def packed(self, rho: torch.Tensor, vel: torch.Tensor, ctx: ForceContext) -> torch.Tensor:
        """`pack`'s vector of the map on rho and vel, on their device."""
        key = graph_key(rho, vel)
        g = self.graphs.get(key)
        if g is not None:
            with span("forces.replay"):
                g[0].replay()
            count("forces.graph")
            return g[1]
        if len(self.graphs) < self.LIMIT:
            with span("forces.capture"):
                g = self.graphs[key] = self._capture(rho, vel, ctx)
                g[0].replay()
            count("forces.capture")
            return g[1]
        count("forces.eager")
        return _packed(rho, vel, ctx)

    def _capture(self, rho, vel, ctx: ForceContext):
        """(the captured graph, its output vector)."""
        dev = rho.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _packed(rho, vel, ctx)
            torch.cuda.current_stream().wait_stream(side)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool), graphs.no_host_sync():
                out = _packed(rho, vel, ctx)
            self.pool_bytes = graphs.pool_reserved(self.pool, dev) or 0
        return graph, out


def force_result(sums: Sums, ctx: ForceContext) -> ForceResult:
    """The forces, moments, coefficients and maps of the map's results on
    the host, with the half model's doubling."""
    Fp, Fv, M, p, tau_vec = sums
    if ctx.symmetric:
        Fp = np.array([2 * Fp[0], 0.0, 2 * Fp[2]])
        Fv = np.array([2 * Fv[0], 0.0, 2 * Fv[2]])
        M = np.array([0.0, 2 * M[1], 0.0])
    F = Fp + Fv
    res = ForceResult(
        Fx=F[0], Fy=F[1], Fz=F[2],
        Fx_pressure=Fp[0], Fy_pressure=Fp[1], Fz_pressure=Fp[2],
        Fx_viscous=Fv[0], Fy_viscous=Fv[1], Fz_viscous=Fv[2],
        Mx=M[0], My=M[1], Mz=M[2],
        pressure_map=p,
        shear_map=tau_vec,
    )
    F_ref = ctx.q_inf * ctx.area_ref
    M_ref = F_ref * ctx.chord_ref
    if F_ref > 1e-10:
        res.Cd = F[0] / F_ref
        res.Cl = F[2] / F_ref
        res.Cs = F[1] / F_ref
    if M_ref > 1e-10:
        res.Cmx = M[0] / M_ref
        res.Cmy = M[1] / M_ref
        res.Cmz = M[2] / M_ref
    return res


def compute_aerodynamics(state: Dict, ctx: ForceContext) -> ForceResult:
    """Map stresses and integrate forces/coefficients for the finest level
    state (reference: src/forces/surface.jl:592-600).  Span `forces`, with
    `forces.map` (the launches; on a card the graph's capture or replay
    inside it, `ForceGraphs`) and `forces.readback` (the copies to the
    host: one on a card, five on the CPU)."""
    with span("forces"):
        rho, vel = state["rho"], state["vel"]
        if not rho.is_cuda:
            return force_result(eager_sums(rho, vel, ctx), ctx)
        with span("forces.map"):
            out = ctx.graphs.packed(rho, vel, ctx)
        with span("forces.readback"):
            sums = unpack(_fetch(out), ctx.n_tri)
        return force_result(sums, ctx)


@dataclass
class MEMContext:
    """Momentum-exchange force evaluation across the fluid/solid interface
    (the port of `open_ludwig_tpu/ops/forces.py:383-547`, whose docstring
    derives the method; `advanced.forces.method: momentum_exchange`):

        F_lat = sum over links (fluid x_f, direction j with x_f + c_j solid)
                of [ f_j(x_f) + f_jbar(x_f + c_j) ] c_j

    on the committed post-collision state: f_j(x_f) streams into the solid
    next sub-step, and the solid neighbour's f_jbar slot holds the
    reflected population the fluid pulls back (bounce-back or Bouzidi).

    Each link is two flat indices into f.reshape(-1): k * N + cell in the
    port's unpadded (X, Y, Z) strides, int64 (27 x 216M cells is past
    int32).  The rest-state part of each population (w) is subtracted
    before the device sums (bf16 storage already holds g = f - w), and its
    exact float64 flux (`rest_F`, `rest_M`, `rest_F_tri`) is added back on
    the host.  F_phys = F_lat * force_scale; moment arms are in meters."""

    idx_out: torch.Tensor  # (n_links,) int64 flat f-index of the outgoing slot
    idx_in: torch.Tensor  # (n_links,) int64 flat f-index of the reflected slot
    w_k: torch.Tensor  # (n_links,) f32 lattice weight of the link direction
    c: torch.Tensor  # (3, n_links) f32 direction vectors
    r: torch.Tensor  # (3, n_links) f32 meters, link midpoint - moment center
    tri: torch.Tensor  # (n_links,) int64 nearest-triangle id
    n_tri: int
    rest_F: np.ndarray  # (3,) f64 lattice flux of the rest state (~0)
    rest_F_tri: np.ndarray  # (3, n_tri) f64 per-triangle rest flux
    rest_M: np.ndarray  # (3,) f64 rest-state moment contribution
    force_scale: float
    q_inf: float
    area_ref: float
    chord_ref: float
    symmetric: bool
    g_storage: bool  # f tensors hold g = f - w (bf16 storage)

    @property
    def n_links(self) -> int:
        return int(self.idx_out.shape[0])


def make_mem_context(patch, params: DomainParams, mesh: TriMesh,
                     g_storage: bool, device="cpu") -> Optional[MEMContext]:
    """Enumerate fluid->solid interface links from the obstacle mask (one
    shifted-window pass per lattice direction, the reference's order:
    direction-major, then x, y, z of the fluid cell) and attribute each
    link to its nearest STL triangle (cKDTree) for the per-triangle force
    map.  Set-up runs once in numpy; the link arrays go to `device`.  None
    when the level has no obstacle cell."""
    from scipy.spatial import cKDTree

    from .. import lattice as lat

    X, Y, Z = patch.interior
    obs_i = np.asarray(patch.obstacle)[:X, :Y, :Z]
    if not obs_i.any():
        return None
    # obstacle extended by a False ring: neighbors outside the interior
    # (domain faces) never count as wall
    obs_ext = np.zeros((X + 2, Y + 2, Z + 2), bool)
    obs_ext[1:-1, 1:-1, 1:-1] = obs_i
    fluid = ~obs_i
    # restrict the scan to the obstacle bounding box + 1-cell shell
    bidx = np.argwhere(obs_i)
    lo_b = np.maximum(bidx.min(0) - 1, 0)
    hi_b = np.minimum(bidx.max(0) + 2, [X, Y, Z])
    sl = tuple(slice(lo, hi) for lo, hi in zip(lo_b, hi_b))
    fl_sub = fluid[sl]

    gx_l, gy_l, gz_l, k_l = [], [], [], []
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        if cx == 0 and cy == 0 and cz == 0:
            continue
        nb = obs_ext[
            1 + cx + lo_b[0]: 1 + cx + hi_b[0],
            1 + cy + lo_b[1]: 1 + cy + hi_b[1],
            1 + cz + lo_b[2]: 1 + cz + hi_b[2],
        ]
        xs, ys, zs = np.nonzero(fl_sub & nb)
        if len(xs) == 0:
            continue
        gx_l.append(xs + lo_b[0])
        gy_l.append(ys + lo_b[1])
        gz_l.append(zs + lo_b[2])
        k_l.append(np.full(len(xs), k, np.int32))
    if not gx_l:
        return None
    gx = np.concatenate(gx_l).astype(np.int64)
    gy = np.concatenate(gy_l).astype(np.int64)
    gz = np.concatenate(gz_l).astype(np.int64)
    k = np.concatenate(k_l)

    N = X * Y * Z
    cell = (gx * Y + gy) * Z + gz
    ncell = ((gx + lat.C_X[k]) * Y + (gy + lat.C_Y[k])) * Z + (gz + lat.C_Z[k])
    c = np.stack([lat.C_X[k], lat.C_Y[k], lat.C_Z[k]]).astype(np.float64)
    # link midpoints (where the wall crossing sits) in meters, domain frame
    lo = np.asarray(patch.lo, np.float64)
    mid = (np.stack([gx, gy, gz]).astype(np.float64)
           + lo[:, None] + 0.5 + 0.5 * c) * patch.dx
    r = mid - np.asarray(params.moment_center, np.float64)[:, None]
    cent_dom = mesh.centers + np.asarray(params.mesh_offset)[None, :]
    tri = cKDTree(cent_dom).query(mid.T, workers=-1)[1].astype(np.int64)
    n_tri = int(mesh.n_triangles)
    # exact rest-state flux (2 w_j c_j per link) in float64; ~0 for closed
    # bodies, kept so the reported force is exactly the full-f balance
    w = lat.W[k].astype(np.float64)
    rest_dF = 2.0 * w[None, :] * c
    rest_F_tri = np.zeros((3, n_tri))
    np.add.at(rest_F_tri.T, tri, rest_dF.T)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return MEMContext(
        idx_out=t(k.astype(np.int64) * N + cell, torch.int64),
        idx_in=t(lat.OPP[k].astype(np.int64) * N + ncell, torch.int64),
        w_k=t(w.astype(np.float32), torch.float32),
        c=t(c.astype(np.float32), torch.float32),
        r=t(r.astype(np.float32), torch.float32),
        tri=t(tri, torch.int64),
        n_tri=n_tri,
        rest_F=rest_dF.sum(axis=1),
        rest_F_tri=rest_F_tri,
        rest_M=np.cross(r.T, rest_dF.T).sum(axis=0),
        force_scale=float(params.force_scale),
        q_inf=float(0.5 * params.rho_physical * params.u_physical**2),
        area_ref=float(params.reference_area),
        chord_ref=float(params.reference_chord),
        symmetric=bool(params.symmetric),
        g_storage=bool(g_storage),
    )


def _mem_sums(f: torch.Tensor, ctx: MEMContext) -> torch.Tensor:
    """Two gathers from f.reshape(-1), the per-link kick in float32, its
    flux, moment and per-triangle sums on f's device: [F (3), M (3), F_tri
    (3 * n_tri)] as float64."""
    f_flat = f.reshape(-1)
    vo = f_flat.index_select(0, ctx.idx_out).float()
    vi = f_flat.index_select(0, ctx.idx_in).float()
    if not ctx.g_storage:  # f32 storage holds full f; work in deviations g
        vo = vo - ctx.w_k
        vi = vi - ctx.w_k
    dF = (vo + vi)[None, :] * ctx.c  # (3, n_links)
    F = dF.sum(dim=1)
    M = torch.linalg.cross(ctx.r, dF, dim=0).sum(dim=1)
    F_tri = torch.zeros((3, ctx.n_tri), dtype=torch.float32, device=f.device)
    F_tri.index_add_(1, ctx.tri, dF)
    return torch.cat([F, M, F_tri.reshape(-1)]).double()


def compute_aerodynamics_mem(
    state: Dict, ctx: MEMContext, base: Optional[ForceResult] = None
) -> ForceResult:
    """Integrated forces/moments/coefficients by momentum exchange.  When
    `base` (a stress-mapping result) is given, its per-triangle pressure and
    shear maps are kept for the surface VTK and only the integrals are
    replaced; the method has no pressure/viscous split (totals go in Fx
    etc.; the *_pressure/_viscous fields keep the stress-mapping estimate
    when available, else total/zero).  Span `forces`, with `forces.map`
    and `forces.readback` (one copy to the host)."""
    with span("forces"):
        with span("forces.map"):
            sums = _mem_sums(state["f"], ctx)
        with span("forces.readback"):
            sums = _fetch(sums)
        F = (sums[0:3] + ctx.rest_F) * ctx.force_scale
        M = (sums[3:6] + ctx.rest_M) * ctx.force_scale
        if ctx.symmetric:
            F = np.array([2 * F[0], 0.0, 2 * F[2]])
            M = np.array([0.0, 2 * M[1], 0.0])
        res = ForceResult(
            Fx=F[0], Fy=F[1], Fz=F[2],
            Mx=M[0], My=M[1], Mz=M[2],
            Fx_pressure=base.Fx_pressure if base else F[0],
            Fy_pressure=base.Fy_pressure if base else F[1],
            Fz_pressure=base.Fz_pressure if base else F[2],
            Fx_viscous=base.Fx_viscous if base else 0.0,
            Fy_viscous=base.Fy_viscous if base else 0.0,
            Fz_viscous=base.Fz_viscous if base else 0.0,
            pressure_map=base.pressure_map if base else None,
            shear_map=base.shear_map if base else None,
        )
        res.force_map = ((sums[6:].reshape(3, ctx.n_tri) + ctx.rest_F_tri)
                         * ctx.force_scale)  # (3, n_tri) N
        F_ref = ctx.q_inf * ctx.area_ref
        M_ref = F_ref * ctx.chord_ref
        if F_ref > 1e-10:
            res.Cd = F[0] / F_ref
            res.Cl = F[2] / F_ref
            res.Cs = F[1] / F_ref
        if M_ref > 1e-10:
            res.Cmx = M[0] / M_ref
            res.Cmy = M[1] / M_ref
            res.Cmz = M[2] / M_ref
        return res

"""Flow statistics, stability checks, the blocks layout's vorticity and
the control-volume force (port of `open_ludwig_tpu/diagnostics.py`:
FlowStats, compute_flow_stats, check_stability, vorticity_blocks_host,
control_volume_force; reference: src/diagnostics.jl:56-125).
`compute_flow_stats` serves both layouts: rho and the obstacle mask of
one shape."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .spans import count, span


@dataclass
class FlowStats:
    n_fluid: int
    rho_mean: float
    rho_min: float
    rho_max: float
    v_max: float
    kinetic_energy: float


STATS_CHUNK = 1 << 24  # cells a chunk of compute_flow_stats's temporaries


def compute_flow_stats(state: Dict, obstacle: torch.Tensor) -> FlowStats:
    """Masked reductions over the fluid cells of one level (one host sync).
    A level above STATS_CHUNK cells is reduced in runs of whole planes of
    its first axis, so the temporaries stay near STATS_CHUNK cells beside
    the graphed runner's two state buffers (the extrema are exact either
    way; the sums are float32 over the runs).  Span `stats`, with
    `stats.reduce` (the launches) and `stats.readback` (the copy to the
    host, counted as `sync.stats`)."""
    rho, vel = state["rho"], state["vel"]
    with span("stats"):
        with span("stats.reduce"):
            per = max(rho[:1].numel(), 1)
            step = max(1, STATS_CHUNK // per)
            big = torch.tensor(1e30, dtype=torch.float32, device=rho.device)
            zero = torch.zeros((), dtype=torch.float32, device=rho.device)
            counts, parts = [], []
            for a in range(0, rho.shape[0], step):
                r, v = rho[a:a + step], vel[:, a:a + step]
                fluid = ~obstacle[a:a + step]
                v2 = (v * v).sum(dim=0)
                counts.append(fluid.sum())
                parts.append(torch.stack([
                    torch.where(fluid, r, big).min(), torch.where(fluid, r, -big).max(),
                    torch.where(fluid, r, zero).sum(), torch.where(fluid, v2, zero).max(),
                    torch.where(fluid, r * v2, zero).sum()]))
            n_fluid = torch.stack(counts).sum()
            p = torch.stack(parts)
            vals = torch.stack([
                n_fluid.float(), p[:, 2].sum() / n_fluid.clamp(min=1), p[:, 0].min(),
                p[:, 1].max(), torch.sqrt(p[:, 3].max()), 0.5 * p[:, 4].sum()
            ])
        with span("stats.readback"):
            count("sync.stats")
            vals = vals.cpu().tolist()
        return FlowStats(int(vals[0]), *[float(v) for v in vals[1:]])


def check_stability(stats: FlowStats, step: int) -> List[str]:
    warnings = []
    if stats.v_max > 0.3:
        warnings.append(f"High velocity: {stats.v_max:.4f} (Ma > 0.5)")
    if stats.rho_min < 0.5:
        warnings.append(f"Low density: {stats.rho_min:.4f}")
    if stats.rho_max > 1.5:
        warnings.append(f"High density: {stats.rho_max:.4f}")
    return warnings


def vorticity_blocks_host(
    vel: np.ndarray, coords: np.ndarray, bp_shape
) -> np.ndarray:
    """Seam-free |curl u| for the sparse 8^3-block layout: blocks are
    scattered into a dense per-level box and the curl uses mask-aware
    differences (central where both neighbors are active cells, one-sided at
    active-region borders), so values agree across block faces — intra-block
    rolls would fabricate O(u) vorticity sheets at every 8-cell boundary.

    vel: (3, nb, 512) host array (or tensor, fetched to the host) in the
    blocks (c, b, z, y, x) cell order;
    coords: (nb, 3) block (bx, by, bz) coords; bp_shape: block-grid dims.
    Returns (nb, 512) |curl u| per cell.
    """
    nb = vel.shape[1]
    bx, by, bz = (int(s) for s in bp_shape)
    X, Y, Z = bx * 8, by * 8, bz * 8
    dense = np.zeros((3, X, Y, Z), np.float32)
    mask = np.zeros((X, Y, Z), bool)
    if isinstance(vel, torch.Tensor):
        vel = vel.detach().float().cpu().numpy()
    v = np.asarray(vel, np.float32).reshape(3, nb, 8, 8, 8)
    # blocks store cells (z, y, x) fastest-last -> transpose to (x, y, z)
    v = np.transpose(v, (0, 1, 4, 3, 2))
    cx, cy, cz = coords[:, 0], coords[:, 1], coords[:, 2]
    for b in range(nb):
        sl = np.s_[cx[b] * 8 : cx[b] * 8 + 8, cy[b] * 8 : cy[b] * 8 + 8,
                   cz[b] * 8 : cz[b] * 8 + 8]
        dense[(slice(None),) + sl] = v[:, b]
        mask[sl] = True

    def d(f, axis):
        fwd, bwd = np.roll(f, -1, axis), np.roll(f, 1, axis)
        fm, bm = np.roll(mask, -1, axis), np.roll(mask, 1, axis)
        # roll wraps around the box: the wrapped entries are not neighbors
        edge_hi = [slice(None)] * 3
        edge_hi[axis] = slice(-1, None)
        edge_lo = [slice(None)] * 3
        edge_lo[axis] = slice(0, 1)
        fm[tuple(edge_hi)] = False
        bm[tuple(edge_lo)] = False
        return np.where(
            fm & bm, 0.5 * (fwd - bwd),
            np.where(fm, fwd - f, np.where(bm, f - bwd, 0.0)),
        )

    ddx = [d(dense[c], 0) for c in range(3)]
    ddy = [d(dense[c], 1) for c in range(3)]
    ddz = [d(dense[c], 2) for c in range(3)]
    wx = ddy[2] - ddz[1]
    wy = ddz[0] - ddx[2]
    wz = ddx[1] - ddy[0]
    w = np.sqrt(wx * wx + wy * wy + wz * wz)
    out = np.empty((nb, 8, 8, 8), np.float32)
    for b in range(nb):
        out[b] = w[cx[b] * 8 : cx[b] * 8 + 8, cy[b] * 8 : cy[b] * 8 + 8,
                   cz[b] * 8 : cz[b] * 8 + 8]
    # back to the blocks (z, y, x) cell order
    return np.transpose(out, (0, 3, 2, 1)).reshape(nb, 512)


def control_volume_force(
    state: Dict, patch, params, rho_phys: float, margin: int = 2
) -> np.ndarray:
    """Steady control-volume momentum balance over one level's interior:
    F_on_body = -oint[rho u (u.n) + p n] dA over the box faces `margin`
    cells inside the interior, in PHYSICAL newtons (p = (rho-1)/3 lattice
    pressure, momentum flux scaled by rho_phys * velocity_scale^2 * dx^2).

    An independent cross-check of the surface force paths (stress mapping
    and momentum exchange, ops/forces.py): it samples only the far field,
    so it cannot share their near-wall error modes.  Valid when the flow is
    quasi-steady and the body's voxelization lies entirely inside the box
    (VALIDATION.md).  `state` holds rho (X, Y, Z) and vel (3, X, Y, Z),
    tensors or arrays; anything else raises (the reference assumes it).
    """
    rho, vel = (state[k].detach().float().cpu().numpy()
                if isinstance(state[k], torch.Tensor)
                else np.asarray(state[k], np.float32) for k in ("rho", "vel"))
    X, Y, Z = patch.interior
    if rho.shape != (X, Y, Z) or vel.shape != (3, X, Y, Z):
        raise ValueError(
            f"control_volume_force needs rho (X, Y, Z) = {(X, Y, Z)} and vel "
            f"(3, X, Y, Z); got {rho.shape} and {vel.shape}")
    m = margin
    vs = params.velocity_scale
    dx = params.dx_levels[patch.level_id - 1]

    def face_flux(axis: int, side: int) -> np.ndarray:
        idx = m if side == 0 else ([X, Y, Z][axis] - 1 - m)
        sl = [slice(m, X - m), slice(m, Y - m), slice(m, Z - m)]
        sl[axis] = idx
        sl = tuple(sl)
        r = rho[sl]
        u = vel[(slice(None),) + sl]
        n_ax = -1.0 if side == 0 else 1.0
        un = u[axis] * n_ax
        pres = (r - 1.0) / 3.0
        F = np.empty(3)
        for i in range(3):
            F[i] = -np.sum(r * u[i] * un + (pres * n_ax if i == axis else 0.0))
        return F * (rho_phys * vs * vs * dx * dx)

    return sum(face_flux(a, s) for a in range(3) for s in (0, 1))

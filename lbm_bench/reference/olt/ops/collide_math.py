# Frozen copy of open_ludwig_torch/ops/collide_math.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""Collision math: inlet noise, inlet equilibrium and the plain collision.

Port of `open_ludwig_tpu/ops/collide_math.py` (`hash_noise`,
`inlet_equilibrium`, `collide`).  `collide` is the plain PyTorch collision
on flat (27, N) streamed distributions: moments with a 0.01 density floor,
sponge blending toward the freestream, the equilibrium log-law wall-stress
body force, WALE eddy viscosity and regularized BGK with Guo forcing
(reference: src/physics_kernels.jl:152-354).  The CUDA stream-collide
kernel (`csrc/stream_collide.cu`) computes the same physics in the
per-cell factorized form of the JAX package's `collide_unrolled_v2`.

Direction-space contractions are explicit weighted sums over the 27 rows
(`_contract`), in float32, so the result depends on no matmul precision
setting (TF32) of the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import lattice as lat

KAPPA = 0.41

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32), without int64 overflow:
    h * c = h * c_lo + ((h * c_hi) mod 2**16) * 2**16 (mod 2**32)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_noise(gy: torch.Tensor, gz: torch.Tensor, t_seed) -> torch.Tensor:
    """Integer-hash turbulence noise in [-1, 1), bit-exact with the JAX
    package and the reference (reference: src/physics_utils.jl:17-28).

    The JAX version wraps int32 products and shifts as uint32; torch has
    little uint32 support, so this computes in int64 masked to 32 bits,
    which gives the same bits.  `t_seed` is an int or a 0-d integer tensor
    (a captured step's seed, read from the step record on the device)."""
    gy = gy.to(torch.int64)
    gz = gz.to(torch.int64)
    combined = (
        _mul32(gy & _M32, 374761393)
        + _mul32(gz & _M32, 668265263)
        + (((t_seed.to(torch.int64) if isinstance(t_seed, torch.Tensor)
             else int(t_seed)) * 1274126177) & _M32)
        + 1234  # the reference's salt
    ) & _M32
    h = combined
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    low = (h & 0xFFFF).to(torch.float32)
    return low / 32768.0 - 1.0


def inlet_equilibrium(k_cx, w_k, u):
    """Axis-aligned (x-flow) equilibrium used for inlet/outlet/sponge targets
    (reference: src/physics_kernels.jl:99-113)."""
    cu = k_cx * u
    return w_k * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u * u)


def _contract(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(R, K) constant matrix times (K, N) rows as explicit float32 sums."""
    rows = []
    for r in range(mat.shape[0]):
        acc = None
        for k in range(mat.shape[1]):
            c = float(mat[r, k])
            if c == 0.0:
                continue
            term = x[k] if c == 1.0 else (-x[k] if c == -1.0 else c * x[k])
            acc = term if acc is None else acc + term
        rows.append(acc if acc is not None else torch.zeros_like(x[0]))
    return torch.stack(rows)


_CT = lat.C.T.copy()  # (27, 3): c_k . u


def collide(
    f_str: torch.Tensor,  # (27, N) post-streaming distributions, f-space
    vel_nbrs: Tuple[torch.Tensor, ...],  # 6x (3, N): E, W, N, S, T, B
    obstacle: torch.Tensor,  # (N,) bool
    sponge: torch.Tensor,  # (N,)
    wall_dist: torch.Tensor,  # (N,)
    u_inlet: torch.Tensor,  # 0-d float32
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    wall_model: bool,
    sponge_blend: bool,
):
    """Returns (f_out (27, N), rho_out (N,), vel_out (3, N))."""
    dev = f_str.device
    tab = lat.tables(str(dev))
    W, CX = tab["W"], tab["CX"]
    # obstacle bounce-back reads the raw streamed values (the reference's
    # obstacle branch precedes sponge blending)
    f_bb = f_str[tab["OPP"]]

    rho_raw = torch.clamp(f_str.sum(dim=0), min=0.01)
    jmom = _contract(lat.C, f_str)
    inv_rho_raw = 1.0 / rho_raw
    u = jmom * inv_rho_raw

    one_m = 1.0 - sponge
    rho = rho_raw * one_m + sponge  # target rho = 1
    u = torch.stack(
        [u[0] * one_m + u_inlet * sponge, u[1] * one_m, u[2] * one_m]
    )
    if sponge_blend:
        feq_target = inlet_equilibrium(CX, W, u_inlet)  # (27,)
        f_str = f_str * one_m[None, :] + feq_target[:, None] * sponge[None, :]

    if wall_model:
        wd = wall_dist
        u_mag = torch.sqrt((u * u).sum(dim=0))
        nu_visc = (tau - 0.5) / 3.0
        u_tau = (
            u_mag
            * (nu_visc / (wd * u_mag + 1e-10)) ** (1.0 / 7.0)
            * (2.0 * 8.3) ** (-1.0 / 7.0)
        )
        u_tau = torch.clamp(u_tau, min=1e-6)
        y_p = u_tau * wd / nu_visc
        u_plus_law = (1.0 / KAPPA) * torch.log(torch.clamp(y_p, min=1e-10)) + 5.2
        corr = torch.where(
            (y_p > 11.81) & (u_plus_law > 0.1),
            (u_mag / u_tau) / torch.clamp(u_plus_law, min=0.1),
            torch.ones_like(u_mag),
        )
        u_tau = torch.clamp(u_tau * corr, min=1e-6)
        tau_wall = rho * u_tau * u_tau
        tau_res = rho * nu_visc * u_mag / torch.clamp(wd, min=1e-10)
        active = (
            (wd > 0.0)
            & (wd < 10.0)
            & (u_mag > 1e-6)
            & (tau_wall > tau_res)
            & (nu_visc > 1e-10)
        )
        force_mag = torch.where(
            active, (tau_wall - tau_res) / torch.clamp(wd, min=1e-10),
            torch.zeros_like(wd),
        )
        F = -force_mag[None, :] * u / torch.clamp(u_mag, min=1e-20)[None, :]
        u_eq = u + 0.5 * F * inv_rho_raw[None, :]
    else:
        F = None
        u_eq = u
    usq_eq = (u_eq * u_eq).sum(dim=0)

    # WALE eddy viscosity from central differences of the previous step's
    # velocity field (reference: src/physics_kernels.jl:251-301)
    vE, vW, vN, vS, vT, vB = vel_nbrs
    gx = 0.5 * (vE - vW)  # d(ux,uy,uz)/dx
    gy = 0.5 * (vN - vS)
    gz = 0.5 * (vT - vB)
    g11, g12, g13 = gx[0], gy[0], gz[0]
    g21, g22, g23 = gx[1], gy[1], gz[1]
    g31, g32, g33 = gx[2], gy[2], gz[2]

    gsq11 = g11 * g11 + g12 * g21 + g13 * g31
    gsq12 = g11 * g12 + g12 * g22 + g13 * g32
    gsq13 = g11 * g13 + g12 * g23 + g13 * g33
    gsq21 = g21 * g11 + g22 * g21 + g23 * g31
    gsq22 = g21 * g12 + g22 * g22 + g23 * g32
    gsq23 = g21 * g13 + g22 * g23 + g23 * g33
    gsq31 = g31 * g11 + g32 * g21 + g33 * g31
    gsq32 = g31 * g12 + g32 * g22 + g33 * g32
    gsq33 = g31 * g13 + g32 * g23 + g33 * g33

    tr_term = (gsq11 + gsq22 + gsq33) / 3.0
    Sd11, Sd22, Sd33 = gsq11 - tr_term, gsq22 - tr_term, gsq33 - tr_term
    Sd12 = 0.5 * (gsq12 + gsq21)
    Sd13 = 0.5 * (gsq13 + gsq31)
    Sd23 = 0.5 * (gsq23 + gsq32)
    S12 = 0.5 * (g12 + g21)
    S13 = 0.5 * (g13 + g31)
    S23 = 0.5 * (g23 + g32)

    OP1 = Sd11**2 + Sd22**2 + Sd33**2 + 2.0 * (Sd12**2 + Sd13**2 + Sd23**2)
    OP2 = g11**2 + g22**2 + g33**2 + 2.0 * (S12**2 + S13**2 + S23**2)
    OP1_32 = OP1 * torch.sqrt(OP1)
    OP2_52 = OP2 * OP2 * torch.sqrt(torch.clamp(OP2, min=1e-12))
    denom = OP2_52 + OP1 * torch.sqrt(torch.sqrt(torch.clamp(OP1, min=1e-12)))
    nu_eddy = torch.where(
        (OP1 > 1e-12) & (denom > 1e-12),
        (c_wale * c_wale) * OP1_32 / torch.clamp(denom, min=1e-12),
        torch.zeros_like(OP1),
    )
    nu_eddy = torch.clamp(nu_eddy, min=nu_sgs_background)
    omega = 1.0 / torch.clamp(tau + nu_eddy * 3.0, min=0.500001)

    cu = _contract(_CT, u_eq)  # (27, N)
    feq = rho[None, :] * W[:, None] * (
        1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq_eq
    )
    f_neq = f_str - feq
    pi6 = _contract(lat.PI_MAT, f_neq)  # (6, N)
    f_neq_reg = _contract(lat.REG_MAT, pi6)  # (27, N)

    f_coll = feq + (1.0 - omega)[None, :] * f_neq_reg
    if F is not None:
        cF = _contract(_CT, F)
        uF = (u * F).sum(dim=0)  # post-sponge u, like the reference
        ft = 3.0 * W[:, None] * (cF * (1.0 + 3.0 * cu) - uF[None, :])
        f_coll = f_coll + (1.0 - 0.5 * omega)[None, :] * ft

    f_out = torch.where(obstacle[None, :], f_bb, f_coll)
    rho_out = torch.where(obstacle, torch.ones_like(rho), rho)
    vel_out = torch.where(obstacle[None, :], torch.zeros_like(u), u)
    return f_out, rho_out, vel_out

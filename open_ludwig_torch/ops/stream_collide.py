"""The blocks layout's step: D3Q27 stream + BC + WALE + wall model +
regularized-BGK collide on (27, nb, 512) block tensors, in plain PyTorch.

Port of `open_ludwig_tpu/ops/stream_collide.py` (`stream_collide`,
`_parent_interp`, `apply_bouzidi`; reference: src/physics_kernels.jl:9-358).
The JAX package runs this layout as float32 XLA with no Pallas kernel
(docs/ARCHITECTURE.md:56-65), so it has no hand-written kernel here either.
One call advances one level by one sub-step:

  1. pull streaming = a roll of each direction on the flat 512-cell axis of
     every block (one gather with a per-direction index table), then one
     static-index scatter patching every (k, cell) whose source crossed a
     block boundary (neighbour gather / inlet / outlet / mirror /
     coarse-parent interpolation / w_k fallback, precompiled in
     `core.plan.StreamPlan`);
  2. the collision of `ops.collide_math.collide` with the six face
     neighbours' velocities (in-block rolls plus the plan's cross-block
     fix-ups).

The step is functional: it reads its inputs and the parent's states and
writes only tensors it made, so the parent's pre-step state stays intact
for both child sub-steps, and `apply_bouzidi` reads the uncorrected
post-collision snapshot.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from .. import lattice as lat
from ..core.plan import FACE_ROLL
from .collide_math import collide, hash_noise, inlet_equilibrium

# cells per collide call: bounds the collision's transients, as the patch
# layout's plain step does (a multiple of 512, so blocks stay whole)
_COLLIDE_CHUNK = 1 << 21


@lru_cache(maxsize=None)
def _tables(device: str) -> Dict[str, torch.Tensor]:
    """Per-device tables of the block step beside `lattice.tables`: the
    roll of each direction as a source index table (27, 1, 512), C (3, 27)."""
    dev = torch.device(device)
    flat = np.arange(lat.BLOCK_CELLS)
    src = (flat[None, :] - lat.OFF[:, None].astype(np.int64)) % lat.BLOCK_CELLS
    return {
        "roll": torch.as_tensor(src[:, None, :], device=dev),
        "C": torch.as_tensor(lat.C, device=dev),
    }


def _parent_interp(plan: Dict, parent: Dict, temporal_weight: float,
                   use_temporal: bool) -> torch.Tensor:
    """Trilinear + temporal coarse->fine interpolation with f_neq rescaling
    (reference: src/physics_interpolation.jl:16-138), over the static list
    of interface (cell, direction) pairs."""
    pk = plan["parent_k"]  # (np,)
    idx8 = plan["parent_idx"]  # (np, 8)
    val8 = plan["parent_valid"]  # (np, 8) bool
    w3 = plan["parent_w"]  # (np, 3)
    if pk.shape[0] == 0:
        return parent["f"].new_zeros(0)
    dev = str(parent["f"].device)
    C, W = _tables(dev)["C"], lat.tables(dev)["W"]

    Np = parent["rho"].shape[0]
    fidx = pk[:, None] * Np + idx8
    f8 = parent["f"].reshape(-1)[fidx]
    rho8 = parent["rho"][idx8]
    u8 = parent["vel"][:, idx8]  # (3, np, 8)

    if use_temporal and temporal_weight < 0.99:
        tw = float(temporal_weight)
        f8 = parent["f_old"].reshape(-1)[fidx] * (1.0 - tw) + f8 * tw
        rho8 = parent["rho_old"][idx8] * (1.0 - tw) + rho8 * tw
        u8 = parent["vel_old"][:, idx8] * (1.0 - tw) + u8 * tw

    w_k = W[pk]
    # fallback chain: invalid corner 0 -> (w_k, 1, 0); other invalid -> corner 0
    v0 = val8[:, 0]
    f0 = torch.where(v0, f8[:, 0], w_k)
    r0 = torch.where(v0, rho8[:, 0], torch.ones_like(w_k))
    u0 = torch.where(v0[None, :], u8[:, :, 0], torch.zeros_like(u8[:, :, 0]))
    f8 = torch.where(val8, f8, f0[:, None])
    rho8 = torch.where(val8, rho8, r0[:, None])
    u8 = torch.where(val8[None], u8, u0[:, :, None])

    wx, wy, wz = w3[:, 0], w3[:, 1], w3[:, 2]

    def trilin(v):  # v: (..., np, 8), corner order x-fastest
        c00 = v[..., 0] * (1 - wx) + v[..., 1] * wx
        c10 = v[..., 2] * (1 - wx) + v[..., 3] * wx
        c01 = v[..., 4] * (1 - wx) + v[..., 5] * wx
        c11 = v[..., 6] * (1 - wx) + v[..., 7] * wx
        c0 = c00 * (1 - wy) + c10 * wy
        c1 = c01 * (1 - wy) + c11 * wy
        return c0 * (1 - wz) + c1 * wz

    f_int = trilin(f8)
    rho_int = trilin(rho8)
    u_int = trilin(u8)  # (3, np)

    cvec = C[:, pk]  # (3, np)
    cu = (cvec * u_int).sum(dim=0)
    usq = (u_int * u_int).sum(dim=0)
    feq = rho_int * w_k * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return feq + (f_int - feq) * float(plan["fneq_rescale"])


def stream_collide(
    f_in: torch.Tensor,  # (27, nb, 512) float32
    vel_in: torch.Tensor,  # (3, nb, 512)
    u_inlet,  # float or 0-d float32 tensor
    t_seed: int,  # timestep % 1e6
    static: Dict,  # plan + obstacle/sponge/wall_dist + vel_dst/vel_src
    *,
    tau: float,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    use_temporal: bool,
    temporal_weight: float = 0.0,
    parent: Optional[Dict] = None,
):
    """Returns (f_out, rho_out, vel_out), new tensors."""
    nb = f_in.shape[1]
    N = nb * lat.BLOCK_CELLS
    dev = f_in.device
    roll = _tables(str(dev))["roll"]
    W, CX = lat.tables(str(dev))["W"], lat.tables(str(dev))["CX"]
    plan = static["plan"]
    u_in = (u_inlet if isinstance(u_inlet, torch.Tensor) else
            torch.full((), u_inlet, dtype=torch.float32, device=dev))

    # ---- 1. streaming: roll within blocks ----------------------------------
    f_str = torch.gather(f_in, 2, roll.expand(27, nb, lat.BLOCK_CELLS))

    # ---- fix-ups for block-crossing / boundary sources ----------------------
    f_flat = f_in.reshape(-1)
    vals = [f_flat[plan["gather_src"]]]

    ik = plan["inlet_k"]
    if ik.shape[0]:
        if inlet_turbulence > 0.0:
            noise = hash_noise(plan["inlet_gy"], plan["inlet_gz"], t_seed)
            u_inst = u_in + noise * float(inlet_turbulence) * u_in
        else:
            u_inst = u_in.expand(ik.shape)
        vals.append(inlet_equilibrium(CX[ik], W[ik], u_inst))

    ok = plan["outlet_k"]
    if ok.shape[0]:
        vals.append(inlet_equilibrium(CX[ok], W[ok], u_in))

    vals.append(plan["const_val"])
    if parent is not None:
        vals.append(_parent_interp(plan, parent, temporal_weight, use_temporal))

    vals = torch.cat(vals)[plan["scatter_perm"]]
    f_str = f_str.reshape(-1).index_put_((plan["scatter_dst"],), vals)
    f_str = f_str.reshape(27, N)

    # ---- 2. collision -------------------------------------------------------
    vel_flat = vel_in.reshape(3, N)
    nbrs = []
    for i in range(6):
        r = torch.roll(vel_in, FACE_ROLL[i], dims=-1).reshape(3, N)
        r[:, static["vel_dst"][i]] = vel_flat[:, static["vel_src"][i]]
        nbrs.append(r)

    obstacle, sponge, wall_dist = (static[key].reshape(N) for key in
                                   ("obstacle", "sponge", "wall_dist"))
    f_out = torch.empty_like(f_str)
    rho_out = torch.empty(N, dtype=torch.float32, device=dev)
    vel_out = torch.empty((3, N), dtype=torch.float32, device=dev)
    for a in range(0, N, _COLLIDE_CHUNK):
        c = slice(a, a + _COLLIDE_CHUNK)
        f_out[:, c], rho_out[c], vel_out[:, c] = collide(
            f_str[:, c],
            tuple(nb_[:, c] for nb_ in nbrs),
            obstacle[c],
            sponge[c],
            wall_dist[c],
            u_in,
            tau=tau,
            c_wale=c_wale,
            nu_sgs_background=nu_sgs_background,
            wall_model=wall_model,
            sponge_blend=sponge_blend,
        )
    return (
        f_out.reshape(27, nb, lat.BLOCK_CELLS),
        rho_out.reshape(nb, lat.BLOCK_CELLS),
        vel_out.reshape(3, nb, lat.BLOCK_CELLS),
    )


def apply_bouzidi(f_out: torch.Tensor, bz: Dict) -> torch.Tensor:
    """Second-order interpolated bounce-back overwrite of f_out[cell, opp_k]
    (reference: src/bouzidi_kernel.jl:13-92): every link's value from the
    uncorrected post-collision snapshot, then one static scatter into a
    copy."""
    flat = f_out.reshape(-1)
    vals = bz["coef_a"] * flat[bz["src_k"]] + bz["coef_b"] * flat[bz["src_other"]]
    return flat.clone().index_put_((bz["dst"],), vals).reshape(f_out.shape)

# Frozen copy of open_ludwig_torch/ops/dense_step.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""Dense-patch stream + BC + collide, ghost planes and Bouzidi: plain PyTorch.

Port of the XLA path of `open_ludwig_tpu/ops/dense_step.py`, cut to the
plain versions the benchmark's reference runs:

  - `dense_stream_collide`: one sub-step of one level (K1's plain version).
    Streaming is a 3-axis roll per direction; every boundary condition is a
    masked select on the destination face row, in the reference precedence
    inlet > outlet > y-mirror > z-mirror, with interface faces read from
    per-face ghost planes (reference: src/physics_kernels.jl:99-120);
  - the ghost planes, trilinearly and temporally interpolated from the
    parent with the reference's parity-biased corner rule and f_neq
    rescaling (reference: src/physics_interpolation.jl:16-138) by the
    endpoint path `interface_endpoints[_pair]` / `interface_from_endpoints`
    + `shift_planes` (the reference's XLA path, the plain reference the
    port's matrix-product path is held to): planes pre-shifted (27, A, B)
    per face, in the level's storage type, as K1 reads them;
  - `build_bouzidi_dense_plan` / `apply_bouzidi_dense`: the Bouzidi
    sub-box correction (reference: src/bouzidi_kernel.jl:38-88), swept
    over the box (K2's plain version).

Arrays are unpadded: every level's state is (27, X, Y, Z) over its
interior (the port drops the TPU's y->8 / z->128 tile padding).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import lattice as lat
from ..core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from .collide_math import _CT, _contract, collide, hash_noise, inlet_equilibrium
from .storage import decode_f


def _upsample_axis(slab: torch.Tensor, axis: int, g_start: int, length: int):
    """2x refinement along `axis` with the reference's parity-biased corner
    rule: fine cell g interpolates parent cells (g//2 - 1, g//2) with weight
    0.25 (g even) / 0.75 (g odd) on the upper corner.  `slab` covers parent
    cells starting at j0 = g_start//2 - 1; returns `length` fine samples
    starting at global fine coordinate g_start."""
    n = slab.shape[axis]
    a = slab.narrow(axis, 0, n - 1)
    b = slab.narrow(axis, 1, n - 1)
    even = 0.75 * a + 0.25 * b
    odd = 0.25 * a + 0.75 * b
    inter = torch.stack([even, odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] = 2 * even.shape[axis]
    inter = inter.reshape(shape)
    # first fine sample of `inter` is g = 2*(j0+1) = 2*(g_start//2)
    off = g_start - 2 * (g_start // 2)
    return inter.narrow(axis, off, length)


def _face_geom(face: int, patch: PatchLevel):
    axis = face // 2
    t_axes = [ax for ax in range(3) if ax != axis]
    g_face = (
        patch.lo[axis] - 1 if face % 2 == 0
        else patch.lo[axis] + patch.interior[axis]
    )
    return axis, t_axes, g_face


def interface_endpoints(
    patch: PatchLevel,
    parent: PatchLevel,
    p_state: Optional[Dict],
    _states: Optional[List[Dict]] = None,
) -> Dict[int, Dict]:
    """Per interface face: trilinearly upsampled (f, rho, u) ghost planes of
    ONE parent state, f decoded to float32 f-space.  The temporal blend is
    linear and commutes with the slab/upsample pipeline, so the scheduler
    computes endpoints once per parent step for (old, new) and each fine
    sub-step only lerps and applies the nonlinear feq/rescale
    (interface_from_endpoints).  With `_states`, a batch of parent states
    shares one op sequence on a leading axis.

    Slabs are gathered with clamped indices, which is the reference's
    slice-then-edge-pad (the clamp only engages where a child face touches
    the parent's edge)."""
    states = _states if _states is not None else [p_state]
    batched = _states is not None
    extra = 1 if batched else 0
    out = {}
    for face in range(6):
        if patch.face_bc[face] != BC_INTERFACE:
            continue
        axis, t_axes, g_face = _face_geom(face, patch)
        A = patch.interior[t_axes[0]]
        B = patch.interior[t_axes[1]]
        p0 = g_face // 2 - 1
        w_face = 0.25 + 0.5 * (g_face % 2)
        gA0 = patch.lo[t_axes[0]] - 1
        gB0 = patch.lo[t_axes[1]] - 1

        def slab(arr, lead, _axis=axis, _t=t_axes, _p0=p0, _A=A, _B=B,
                 _gA0=gA0, _gB0=gB0, _face=face):
            for ax in range(3):
                if ax == _axis:
                    lo_l = _p0 - parent.lo[ax]
                    want = (lo_l, lo_l + 2)
                else:
                    g0 = _gA0 if ax == _t[0] else _gB0
                    ln = _A + 2 if ax == _t[0] else _B + 2
                    j0 = g0 // 2 - 1
                    j1 = (g0 + ln - 1) // 2
                    want = (j0 - parent.lo[ax], j1 - parent.lo[ax] + 1)
                cap = arr.shape[lead + ax]
                if min(want[1], cap) <= max(want[0], 0):
                    raise ValueError(
                        f"interface slab empty: face {_face} axis {ax} wants "
                        f"{want}, parent extent {cap}"
                    )
                idx = torch.arange(want[0], want[1], device=arr.device)
                arr = arr.index_select(lead + ax, idx.clamp(0, cap - 1))
            perm = list(range(lead)) + [lead + _axis] + [lead + a for a in _t]
            return arr.permute(perm)

        def interp(key, lead, _w=w_face, _gA0=gA0, _gB0=gB0, _A=A, _B=B):
            if batched:
                sl = torch.stack([slab(st[key], lead) for st in states])
            else:
                sl = slab(p_state[key], lead)
            lead = lead + extra
            if key == "f":
                sl = decode_f(sl, k_axis=extra)  # bf16 g -> f32 f
            s0 = sl.select(lead, 0)
            s1 = sl.select(lead, 1)
            v = (1.0 - _w) * s0 + _w * s1
            v = _upsample_axis(v, lead, _gA0, _A + 2)
            v = _upsample_axis(v, lead + 1, _gB0, _B + 2)
            return v

        out[face] = {
            "f": interp("f", 1),  # ([extra,] 27, A+2, B+2)
            "rho": interp("rho", 0),  # ([extra,] A+2, B+2)
            "vel": interp("vel", 1),  # ([extra,] 3, A+2, B+2)
        }
    return out


def interface_endpoints_pair(
    patch: PatchLevel, parent: PatchLevel, p_old: Dict, p_new: Dict,
) -> Tuple[Dict[int, Dict], Dict[int, Dict]]:
    """(old, new) endpoint planes in ONE slab/upsample pass."""
    both = interface_endpoints(patch, parent, None, _states=[p_old, p_new])
    old = {f: {k: v[0] for k, v in d.items()} for f, d in both.items()}
    new = {f: {k: v[1] for k, v in d.items()} for f, d in both.items()}
    return old, new


def interface_from_endpoints(
    ep_new: Dict[int, Dict],
    ep_old: Optional[Dict[int, Dict]],
    patch: PatchLevel,
    parent: PatchLevel,
    temporal_weight: float,
    use_temporal: bool,
) -> Dict[int, torch.Tensor]:
    """Temporal lerp of endpoint planes + equilibrium split + f_neq rescale
    clamped to [0.01, 100] (reference: src/physics_interpolation.jl:69-138).
    Returns face -> float32 f-space plane (27, A+2, B+2), which
    `shift_planes` turns into the form the steps read."""
    scale = _fneq_scale(patch, parent)
    blend = use_temporal and ep_old is not None and temporal_weight < 0.99
    out = {}
    for face, new in ep_new.items():
        if blend and temporal_weight == 0.0:
            old = ep_old[face]
            f_int, rho_int, u_int = old["f"], old["rho"], old["vel"]
        elif blend:
            old = ep_old[face]
            tw = temporal_weight
            f_int = old["f"] * (1.0 - tw) + new["f"] * tw
            rho_int = old["rho"] * (1.0 - tw) + new["rho"] * tw
            u_int = old["vel"] * (1.0 - tw) + new["vel"] * tw
        else:
            f_int, rho_int, u_int = new["f"], new["rho"], new["vel"]
        W = lat.tables(str(f_int.device))["W"]
        cu = _contract(_CT, u_int)
        usq = (u_int * u_int).sum(dim=0)
        feq = rho_int[None] * W[:, None, None] * (
            1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq
        )
        out[face] = feq + (f_int - feq) * scale
    return out


def _fneq_scale(patch: PatchLevel, parent: PatchLevel) -> float:
    tau_c = parent.tau - 0.5
    tau_f = patch.tau - 0.5
    return float(np.clip(tau_f / tau_c, 0.01, 100.0)) if tau_c > 1e-6 else 1.0


def shift_planes(raw: Dict[int, torch.Tensor], patch: PatchLevel, g_shifted: bool,
                 dtype) -> Dict[int, torch.Tensor]:
    """Raw ghost planes ([nw,] 27, A+2, B+2), float32 f-space (the endpoint
    path's `interface_from_endpoints`), in the form K1 and K3 read: per
    direction k the window at transverse offset (1 - c_t), so that
    plane[k, a, b] is the value for destination cell (a, b) of the face,
    minus w_k first with `g_shifted`, then cast to `dtype`: ([nw,] 27, A, B)
    contiguous (reference: prep_iface_pallas + _shift_planes,
    pallas_step.py:215-240, dense_step.py:254-280)."""
    out = {}
    for face, pl in raw.items():
        if g_shifted:
            pl = pl - lat.tables(str(pl.device))["W"].view(27, 1, 1)
        t = [a for a in range(3) if a != face // 2]
        A, B = patch.interior[t[0]], patch.interior[t[1]]
        rows = []
        for k in range(27):
            c = (int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k]))
            s0, s1 = 1 - c[t[0]], 1 - c[t[1]]
            rows.append(pl[..., k, s0:s0 + A, s1:s1 + B])
        out[face] = torch.stack(rows, dim=-3).to(dtype)
    return out


def _u32(u_inlet, device) -> torch.Tensor:
    return torch.as_tensor(u_inlet, dtype=torch.float32, device=device)


_COLLIDE_CHUNK = 1 << 21  # cells per collide call of the plain step
# The plain collision runs on whole blocks of this many cells: PyTorch's
# CPU kernels compute a ragged tail of an array on a scalar path, whose
# float32 results (log, pow, the 27-row sums) may differ from the
# vector path's by a rounding, so a cell's result would depend on where
# it lies in the array; padded to whole blocks it does not, and an x slab
# of a level (its own array) steps bit for bit as the level does.
_CELL_BLOCK = 128


def _roll3(a: torch.Tensor, cx: int, cy: int, cz: int) -> torch.Tensor:
    """out[..., x, y, z] = a[..., x - cx, y - cy, z - cz], periodic."""
    if (cx, cy, cz) == (0, 0, 0):
        return a
    return torch.roll(a, (cx, cy, cz), dims=(-3, -2, -1))


def dense_stream_collide(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f-space
    vel: torch.Tensor,  # (3, X, Y, Z)
    u_inlet,
    t_seed: int,
    static: Dict,  # obstacle (bool) / sponge / wall_dist, each (X, Y, Z)
    patch: PatchLevel,
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    iface: Optional[Dict[int, torch.Tensor]] = None,  # face -> (27, A, B)
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    x_off: int = 0,
):
    """One stream-collide sub-step; returns (f, rho, vel) of the level.
    `iface` holds each interface face's pre-shifted ghost plane (27, A, B)
    in its level's storage type (`interface_planes_pair_mm`,
    `shift_planes`): float32 f, or bf16 g = f - w, decoded here.

    With `edges` = (f_edges (27, 2, Y, Z) float32 f-space, v_edges (3, 2,
    Y, Z)), f, vel and the statics are one x slab (27, XL, Y, Z) of the
    level `patch`, from its global plane `x_off` (the JAX package's
    shard_nx step, ops/pallas_step.py:562-611): a slot pulled across the
    slab's x ends comes from the neighbour slab's edge plane ([:, 0] the
    previous slab's last plane, [:, 1] the next one's first), shifted in y
    and z; the z faces, then the y faces win over it, and the x faces hold
    at the level's global x = 0 and X - 1 only; velocity neighbours across
    the ends come from v_edges, the cell itself standing in at the global
    ends.  The y and z faces' planes are the slab's (27, XL, B); an x face's
    whole plane is read only by the slab that holds it."""
    return _stream_collide(
        _roll3, f, vel, u_inlet, t_seed, static, patch, c_wale=c_wale,
        nu_sgs_background=nu_sgs_background, inlet_turbulence=inlet_turbulence,
        wall_model=wall_model, sponge_blend=sponge_blend, iface=iface,
        edges=edges, x_off=x_off)


def _with_edges(shift, edges_ax: torch.Tensor, lead: int):
    """shift(a, ...) for an x slab `a` whose x ends continue into the edge
    planes `edges_ax` ([..., 0, :, :] before the slab, [..., 1, :, :] after
    it): the shift of [before | a | after] over the slab's planes."""
    def slab_shift(a, cx, cy, cz):
        ext = torch.cat([edges_ax.narrow(lead, 0, 1), a, edges_ax.narrow(lead, 1, 1)],
                        dim=lead)
        return shift(ext, cx, cy, cz).narrow(lead, 1, a.shape[lead])
    return slab_shift


def _stream_collide(shift, f, vel, u_inlet, t_seed, static, patch, *, c_wale,
                    nu_sgs_background, inlet_turbulence, wall_model,
                    sponge_blend, iface=None, edges=None, x_off=0):
    """dense_stream_collide with the shift of a slot's source given:
    shift(a, cx, cy, cz)[..., x, y, z] = a[..., x - cx, y - cy, z - cz] on
    every cell the boundary masks keep.  `edges` and `x_off`: the slab form
    (dense_stream_collide)."""
    X, Y, Z = patch.interior
    XL = f.shape[1]
    if edges is None and (XL != X or x_off != 0):
        raise ValueError(f"an x slab ({XL} of {X} planes from {x_off}) needs edges")
    if x_off < 0 or x_off + XL > X:
        raise ValueError(f"slab of {XL} planes from {x_off} outside {X}")
    N = XL * Y * Z
    fb = patch.face_bc
    dev = f.device
    u_in = _u32(u_inlet, dev)
    W = lat.tables(str(dev))["W"]

    ix = torch.arange(x_off, x_off + XL, device=dev).view(XL, 1, 1)
    iy = torch.arange(Y, device=dev).view(1, Y, 1)
    iz = torch.arange(Z, device=dev).view(1, 1, Z)
    v_shift = shift if edges is None else _with_edges(shift, edges[1], 1)

    # shared inlet factor plane over (Y, Z): cu = +u_inst for all cx=+1
    inlet_factor = None
    if fb[0] == BC_INLET:
        gy1 = torch.arange(Y, device=dev).view(Y, 1) + (patch.lo[1] + 1)
        gz1 = torch.arange(Z, device=dev).view(1, Z) + (patch.lo[2] + 1)
        if inlet_turbulence > 0.0:
            noise = hash_noise(gy1.expand(Y, Z), gz1.expand(Y, Z), t_seed)
            u_inst = u_in + noise * inlet_turbulence * u_in
        else:
            u_inst = u_in.expand(Y, Z)
        inlet_factor = (
            1.0 + 3.0 * u_inst + 4.5 * u_inst * u_inst - 1.5 * u_inst * u_inst
        )
    outlet_vals = inlet_equilibrium(lat.tables(str(dev))["CX"], W, u_in)

    def face_value(k, face):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        bc = fb[face]
        if bc == BC_INTERFACE:
            v = iface[face][k]  # (A, B), pre-shifted
            if v.dtype == torch.bfloat16:
                v = v.float() + W[k]
            return v.unsqueeze(face // 2)
        if bc == BC_INLET:
            return (W[k] * inlet_factor)[None, :, :]
        if bc == BC_OUTLET:
            return outlet_vals[k]
        if bc == BC_MIRROR_Y:
            return f[int(lat.MIRROR_Y[k])]
        if bc == BC_MIRROR_Z:
            return f[int(lat.MIRROR_Z[k])]
        raise ValueError(f"unknown face bc {bc}")

    f_str = torch.empty((27, N), dtype=f.dtype, device=dev)
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        val = (shift(f[k], cx, cy, cz) if edges is None
               else _with_edges(shift, edges[0][k], 0)(f[k], cx, cy, cz))
        # masked overrides in reverse precedence (inlet strongest, applied
        # last; reference precedence inlet > outlet > y-mirror > z-mirror)
        if cz > 0:
            val = torch.where(iz == 0, face_value(k, 4), val)
        elif cz < 0:
            val = torch.where(iz == Z - 1, face_value(k, 5), val)
        if cy > 0:
            val = torch.where(iy == 0, face_value(k, 2), val)
        elif cy < 0:
            val = torch.where(iy == Y - 1, face_value(k, 3), val)
        # (an x face only on the slab that holds it)
        if cx < 0 and x_off + XL == X:
            val = torch.where(ix == X - 1, face_value(k, 1), val)
        elif cx > 0 and x_off == 0:
            val = torch.where(ix == 0, face_value(k, 0), val)
        f_str[k] = val.reshape(N)

    # velocity face neighbours with self-fallback at every patch face
    # (reference: src/physics_utils.jl:45-70)
    def vel_nbr(dx, dy, dz):
        r = v_shift(vel, -dx, -dy, -dz)
        for d, idx, n in ((dx, ix, X), (dy, iy, Y), (dz, iz, Z)):
            if d > 0:
                r = torch.where(idx == n - 1, vel, r)
            elif d < 0:
                r = torch.where(idx == 0, vel, r)
        return r.reshape(3, N)

    nbrs = (
        vel_nbr(1, 0, 0), vel_nbr(-1, 0, 0),
        vel_nbr(0, 1, 0), vel_nbr(0, -1, 0),
        vel_nbr(0, 0, 1), vel_nbr(0, 0, -1),
    )
    # the collision is local to each cell: it runs over chunks of cells,
    # which bounds its transients (a 63.7M-cell level fits one card)
    obstacle, sponge, wall_dist = (static[key].reshape(N) for key in
                                   ("obstacle", "sponge", "wall_dist"))
    f_out = torch.empty_like(f_str)
    rho_out = torch.empty(N, dtype=torch.float32, device=dev)
    vel_out = torch.empty((3, N), dtype=torch.float32, device=dev)
    for a in range(0, N, _COLLIDE_CHUNK):
        c = slice(a, a + _COLLIDE_CHUNK)
        n_c = min(N - a, _COLLIDE_CHUNK)
        pad = -n_c % _CELL_BLOCK

        def blocks(t, fill):
            """t's cells of this chunk, padded to whole blocks by `fill`."""
            t = t[..., c]
            return t if not pad else torch.cat(
                [t, t.new_full(t.shape[:-1] + (pad,), fill)], dim=-1)

        fo, ro, vo = collide(
            blocks(f_str, 0.0),
            tuple(blocks(nb, 0.0) for nb in nbrs),
            blocks(obstacle, False),
            blocks(sponge, 0.0),
            blocks(wall_dist, 100.0),
            u_in,
            tau=patch.tau,
            c_wale=c_wale,
            nu_sgs_background=nu_sgs_background,
            wall_model=wall_model,
            sponge_blend=sponge_blend,
        )
        f_out[:, c], rho_out[c], vel_out[:, c] = fo[:, :n_c], ro[:n_c], vo[:, :n_c]
    return (
        f_out.reshape(27, XL, Y, Z),
        rho_out.reshape(XL, Y, Z),
        vel_out.reshape(3, XL, Y, Z),
    )


def build_bouzidi_dense_plan(patch: PatchLevel, q_min: float) -> Optional[Dict]:
    """Dense sub-box Bouzidi plan (numpy): the bounding box of the boundary
    cells plus a one-cell halo, clipped to the level, and one signed
    coefficient array S (27, bx, by, bz):

      val = |S| f*[k](cell) + (1-|S|) (f*[opp k](cell) if S < 0
                                       else f*[k](cell + c_opp))

    written into slot opp(k); S's sign encodes the q >= 0.5 branch and S = 0
    means no link (reference: src/bouzidi_kernel.jl:38-88).  The JAX
    package additionally aligns the box to the TPU's (8, 128) tile; the
    port keeps the tight box.  The plan also holds the level's shape.
    Returns None without a link."""
    bz = patch.bouzidi
    if bz is None or bz.n_boundary_cells == 0:
        return None
    X, Y, Z = patch.interior
    lo = np.array([bz.cell_gx.min(), bz.cell_gy.min(), bz.cell_gz.min()]) - 1
    hi = np.array([bz.cell_gx.max(), bz.cell_gy.max(), bz.cell_gz.max()]) + 2
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, [X, Y, Z])
    bdim = tuple(int(v) for v in (hi - lo))

    q = bz.q_map.astype(np.float32)  # (nc, 27)
    cx = bz.cell_gx - lo[0]
    cy = bz.cell_gy - lo[1]
    cz = bz.cell_gz - lo[2]
    S = np.zeros((27,) + bdim, np.float32)
    for k in range(27):
        if k == 13:
            continue
        qv = q[:, k]
        act = (qv > q_min) & (qv <= 1.0)
        if not act.any():
            continue
        sel = np.nonzero(act)[0]
        qs = qv[sel]
        lo_case = qs < 0.5
        # x_ff = cell + c_opp; fall back to f[k] at the cell when outside
        o = int(lat.OPP[k])
        gx = bz.cell_gx[sel] + lat.C_X[o]
        gy = bz.cell_gy[sel] + lat.C_Y[o]
        gz = bz.cell_gz[sel] + lat.C_Z[o]
        inside = (
            (gx >= 0) & (gx < X) & (gy >= 0) & (gy < Y) & (gz >= 0) & (gz < Z)
        )
        a = np.where(lo_case, np.where(inside, 2.0 * qs, 1.0), 1.0 / (2.0 * qs))
        S[k, cx[sel], cy[sel], cz[sel]] = np.where(lo_case, a, -a)
    if not S.any():
        return None
    lo = tuple(int(v) for v in lo)
    return {"lo": lo, "dim": bdim, "level": (X, Y, Z), "S": S}


def bouzidi_plan_to(plan: Optional[Dict], device) -> Optional[Dict]:
    """A plan with S as a tensor on `device`."""
    if plan is None:
        return None
    return {**plan, "S": torch.as_tensor(plan["S"], device=device)}


def _bouzidi_box(f_out: torch.Tensor, plan: Dict, link) -> torch.Tensor:
    """The Bouzidi box sweep shared by both coefficient encodings: for each
    slot j != 13 with link direction k = opp(j),

      f_j = a f*_k(cell) + b (f*_j(cell) if self else f*_k(cell + c_opp k))

    where `link(k)` gives float32 (a, b, self, active) over the box and
    slots with `active` False keep f*_j.  f* is the uncorrected box, and
    the shifted read wraps inside the box.  Returns a new tensor."""
    lx, ly, lz = plan["lo"]
    bx, by, bz_ = plan["dim"]
    box = f_out[:, lx:lx + bx, ly:ly + by, lz:lz + bz_]
    rows = []
    for j in range(27):
        if j == 13:
            rows.append(box[13])
            continue
        k = int(lat.OPP[j])  # the link direction writing into slot j
        ck = (int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k]))
        # f[k] at cell + c_opp = roll by +c (roll(a, s)[i] = a[i - s])
        ff = torch.roll(box[k], ck, dims=(0, 1, 2))
        a, b, self_, active = link(k)
        other = torch.where(self_, box[j].float(), ff.float())
        val = (a * box[k].float() + b * other).to(box.dtype)
        rows.append(torch.where(active, val, box[j]))
    out = f_out.clone()
    out[:, lx:lx + bx, ly:ly + by, lz:lz + bz_] = torch.stack(rows)
    return out


def apply_bouzidi_dense(f_out: torch.Tensor, plan: Dict) -> torch.Tensor:
    """Bouzidi correction of (27, X, Y, Z) with the signed single-array
    coefficients S (K2's plain version), returned as a new tensor.

    Works unchanged on bf16 g-storage: the link coefficients sum to 1 and
    w[opp k] = w[k], so the correction is form-invariant under the f - w
    shift; compute is float32, store is the array's dtype.  plan["S"] is a
    float32 tensor on f's device."""
    def link(k):
        s = plan["S"][k]
        a = s.abs()
        return a, 1.0 - a, s < 0, s != 0

    return _bouzidi_box(f_out, plan, link)

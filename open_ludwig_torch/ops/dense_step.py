"""Dense-patch stream + BC + collide, ghost planes and Bouzidi: plain PyTorch.

Port of the XLA path of `open_ludwig_tpu/ops/dense_step.py`.  These are the
plain versions of the CUDA kernels (the CPU's path, and what the tests hold
the kernels to):

  - `dense_stream_collide`: one sub-step of one level (K1's plain version).
    Streaming is a 3-axis roll per direction; every boundary condition is a
    masked select on the destination face row, in the reference precedence
    inlet > outlet > y-mirror > z-mirror, with interface faces read from
    per-face ghost planes (reference: src/physics_kernels.jl:99-120);
  - the ghost planes, trilinearly and temporally interpolated from the
    parent with the reference's parity-biased corner rule and f_neq
    rescaling (reference: src/physics_interpolation.jl:16-138), two ways:
    the main path's `build_iface_mm_plan` / `extract_endpoint_slabs` /
    `interface_planes_pair_mm` (the reference's Pallas-path pipeline: a
    static plan of small matrices, endpoint slabs the scheduler carries
    across parent steps, two batched matmuls per field and one elementwise
    tail per axis group; on a card the two kernels of `ops/ghost_planes.py`
    compute the last two from the plan's tap tables, `iface_taps`), and
    the endpoint path
    `interface_endpoints[_pair]` / `interface_from_endpoints` +
    `shift_planes` (the reference's XLA path), the plain reference the
    main path's planes are held to.  Both give planes pre-shifted (27, A,
    B) per face, in the level's storage type, as K1 and K3 read them;
  - `build_bouzidi_dense_plan` / `apply_bouzidi_dense`: the Bouzidi
    sub-box correction (reference: src/bouzidi_kernel.jl:38-88), its link
    list (`bouzidi_links`) and `apply_bouzidi_links`, the same correction
    over the links (K2's plain version); `apply_bouzidi_ab_plain`, the
    box sweep with the retired two-array coefficients, and
    `apply_bouzidi_ab_links`, the same over their link list
    (`bouzidi_ab_links`, K6's plain version);
  - `fused_pair_plain`: two sub-steps with the correction of the first
    between them (K3's plain version);
  - `stream_collide_flat_plain`: the sub-step of an interface-free level
    with the flat-(y,z) shifts (K4's plain version), and
    `stream_collide_inplace_plain`: the sub-step written back into its
    input f (K5's plain version).

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
from .storage import STORE_BF16, decode_f, encode_f


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


def _slab_geom(face: int, patch: PatchLevel, parent: PatchLevel) -> Dict:
    """Slice/pad geometry of one interface face's parent slab (the index
    math of interface_endpoints' slab), against the parent's interior."""
    axis, t_axes, g_face = _face_geom(face, patch)
    A, B = patch.interior[t_axes[0]], patch.interior[t_axes[1]]
    p0 = g_face // 2 - 1
    gA0 = patch.lo[t_axes[0]] - 1
    gB0 = patch.lo[t_axes[1]] - 1
    rng, pads = {}, {}
    for ax in range(3):
        if ax == axis:
            lo_l = p0 - parent.lo[ax]
            want = (lo_l, lo_l + 2)
        else:
            g0 = gA0 if ax == t_axes[0] else gB0
            ln = A + 2 if ax == t_axes[0] else B + 2
            want = (g0 // 2 - 1 - parent.lo[ax], (g0 + ln - 1) // 2 - parent.lo[ax] + 1)
        hi_cap = parent.interior[ax]
        got = (max(want[0], 0), min(want[1], hi_cap))
        if got[1] <= got[0]:
            raise ValueError(f"interface slab empty: face {face} axis {ax} wants "
                             f"{want}, parent extent {hi_cap}")
        rng[ax] = got
        pads[ax] = (got[0] - want[0], want[1] - got[1])
    return {"axis": axis, "t_axes": t_axes, "A": A, "B": B, "gA0": gA0,
            "gB0": gB0, "w_face": 0.25 + 0.5 * (g_face % 2), "rng": rng,
            "pads": pads}


def _clamped_matrix_cols(weights_by_parent: list, start: int, width: int,
                         lo_cap: int, hi_cap: int) -> np.ndarray:
    """Rows of [(parent_cell, weight), ...] -> (n_rows, width) matrix over
    slab columns [start, start + width), parent cells outside [lo_cap,
    hi_cap) clamped to the nearest one inside (the edge-pad of the
    reference's slab extraction)."""
    M = np.zeros((len(weights_by_parent), width), np.float32)
    for i, pairs in enumerate(weights_by_parent):
        for cell, wt in pairs:
            cell = min(max(cell, lo_cap), hi_cap - 1)
            M[i, cell - start] += wt
    return M


def build_iface_mm_plan(patch: PatchLevel, parent: PatchLevel) -> Optional[Dict]:
    """Static plan of interface_planes_pair_mm for child level `patch` (numpy;
    `iface_mm_plan_to` adds its device tensors), or None without an
    interface face.  Per interface-face axis group: the parent slab's
    window (per-face starts, common sizes), the normal lerp's two slab
    planes and weight per face ("lerp_idx"; also as the 2-hot matrix UN2
    (nf, wn)), and UA3 (3, A, wa) / UB3 (3, B, wb): the 2x upsample
    (parity-biased corner rule), the edge clamp and the per-direction
    (1 - c) window shift along each transverse axis, one matrix per class
    c + 1 of the direction's component along that axis.  The reference's
    plan (open_ludwig_tpu/ops/dense_step.py:415-562) for a parent whose
    alignment is 1 on every axis (flat-(y, z)); the port's parents are
    (27, X, Y, Z) over their interior, so the caps are the interior."""
    need = [f for f in range(6) if patch.face_bc[f] == BC_INTERFACE]
    if not need:
        return None
    caps = tuple(parent.interior)

    def wide_range(want_lo: int, want_hi: int, ax: int, width: Optional[int] = None):
        """Slice [start, start + width) covering want within [0, cap)."""
        cap = caps[ax]
        start = max(want_lo, 0)
        w = min(want_hi, cap) - start
        if width is not None:
            w = max(w, width)
        w = min(w, cap)
        return min(start, cap - w), w

    groups = []
    for ax in range(3):
        faces = [f for f in need if f // 2 == ax]
        if not faces:
            continue
        geoms = [_slab_geom(f, patch, parent) for f in faces]
        g0 = geoms[0]
        t0, t1 = g0["t_axes"]
        A, B = g0["A"], g0["B"]

        def t_want(t_ax, g_t0, ln):
            # parent-LOCAL cell range (child coordinates are global at the
            # child level; the slab slices the parent's own array)
            return (g_t0 // 2 - 1 - parent.lo[t_ax],
                    (g_t0 + ln - 1) // 2 - parent.lo[t_ax] + 1)

        wA = t_want(t0, g0["gA0"], A + 2)
        wB = t_want(t1, g0["gB0"], B + 2)
        sA, wa = wide_range(wA[0], wA[1], t0)
        sB, wb = wide_range(wB[0], wB[1], t1)
        # normal ranges differ per face; one common width
        n_wants = []
        for g in geoms:
            lo_l = g["rng"][ax][0] - g["pads"][ax][0]
            n_wants.append((lo_l, lo_l + 2))
        wn = max(wide_range(w0, w1, ax)[1] for w0, w1 in n_wants)
        n_ranges = [wide_range(w0, w1, ax, width=wn) for w0, w1 in n_wants]

        lerp_idx = []
        for g, (w0, _), (st, _) in zip(geoms, n_wants, n_ranges):
            i0 = min(max(w0, 0), caps[ax] - 1) - st
            i1 = min(max(w0 + 1, 0), caps[ax] - 1) - st
            lerp_idx.append((i0, i1, g["w_face"]))

        def u_class(g_t0, ln_out, t_ax, want, start, width):
            rows = []
            for i in range(ln_out):
                g = g_t0 + i
                jlo = g // 2 - 1 - parent.lo[t_ax]  # parent-LOCAL cell
                w_hi = 0.25 + 0.5 * (g % 2)
                rows.append([(jlo, 1.0 - w_hi), (jlo + 1, w_hi)])
            # clamp to the CLIPPED want range (edge-pad replicates its ends)
            Mfull = _clamped_matrix_cols(rows, start, width, max(want[0], 0),
                                         min(want[1], caps[t_ax]))
            ln_win = ln_out - 2
            return np.stack([Mfull[2 - ci:2 - ci + ln_win] for ci in range(3)])

        starts = []
        for st, _ in n_ranges:
            s3 = [0, 0, 0]
            s3[ax], s3[t0], s3[t1] = st, sA, sB
            starts.append(tuple(s3))
        size3 = [0, 0, 0]
        size3[ax], size3[t0], size3[t1] = wn, wa, wb
        UN2 = np.zeros((len(faces), wn), np.float32)
        for fi, (i0, i1, wf) in enumerate(lerp_idx):
            UN2[fi, i0] += 1.0 - wf
            UN2[fi, i1] += wf
        groups.append({
            "axis": ax, "faces": faces, "A": A, "B": B, "starts": starts,
            "sizes": tuple(size3), "lerp_idx": lerp_idx,
            "UA3": u_class(g0["gA0"], A + 2, t0, wA, sA, wa),
            "UB3": u_class(g0["gB0"], B + 2, t1, wB, sB, wb),
            "UN2": UN2,
        })
    return {"groups": groups}


def iface_taps(grp: Dict) -> Dict[str, np.ndarray]:
    """The tap tables of one group of `build_iface_mm_plan` that the ghost
    planes' CUDA kernel reads (`ops/ghost_planes.py`): per transverse axis
    (A from UA3, B from UB3), class c + 1 and fine row, the two slab
    columns the row's taps read, ascending, and their weights, after the
    clamp: "col_a" int32 and "w_a" float32 (3, A, 2), "col_b" and "w_b"
    (3, B, 2).  A row of the 2x upsample reads two parent cells; where the
    clamp folded both onto one column, the row reads that column with its
    weight and again with weight 0.  So each row is its matrix row exactly,
    and `build_iface_mm_plan` stays the one definition of the geometry."""
    out = {}
    for ax, key in (("a", "UA3"), ("b", "UB3")):
        M = np.asarray(grp[key], np.float32)
        nz = M != 0
        counts = nz.sum(axis=2)
        if counts.min() < 1 or counts.max() > 2:
            raise ValueError(f"{key}: a row with {counts.min()}..{counts.max()} "
                             "nonzero weights (the upsample's rows have 1 or 2)")
        first = nz.argmax(axis=2)
        last = M.shape[2] - 1 - nz[..., ::-1].argmax(axis=2)
        col = np.stack([first, last], axis=-1).astype(np.int32)
        w = np.take_along_axis(M, col, axis=2)
        w[..., 1] = np.where(first == last, 0.0, w[..., 1])
        out["col_" + ax], out["w_" + ax] = col, w.astype(np.float32)
    return out


# The fused build's tiles (`ops/ghost_planes.build`), (rows along A,
# columns along B) of a face's extended cells (`ext_taps`): three blocks a
# tile, one a normal class of the directions, a thread a cell.  A face
# takes 8 x 16 (for x and y faces 16 along the parent's rows of z); the z
# faces, whose staged values cost a 32-byte sector each, take 16 x 16 in
# two rounds (less halo a cell) where their 8 x 16 tiles alone number one
# a SM of an H100 (132).
BUILD_TILE, BUILD_TILE_Z = (8, 16), (16, 16)
H100_SMS = 132


def _tiles_of(g: Dict, tile: Tuple[int, int]) -> int:
    return len(g["faces"]) * -(-(g["A"] + 2) // tile[0]) * -(-(g["B"] + 2) // tile[1])


def build_blocks(groups, tiles) -> int:
    """The blocks of a fused build of `groups` (a plan's) in `tiles`, one a
    group: three a tile."""
    return 3 * sum(_tiles_of(g, t) for g, t in zip(groups, tiles))


def build_tiles(groups) -> List[Tuple[int, int]]:
    """The fused build's tile of each of a plan's `groups` (see `BUILD_TILE`)."""
    return [BUILD_TILE_Z if g["axis"] == 2 and _tiles_of(g, BUILD_TILE) >= H100_SMS
            else BUILD_TILE for g in groups]


def ext_taps(col: np.ndarray, w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A tap table (3, n, 2) (`iface_taps`) by extended row: (n + 2, 2) columns
    and weights.  Row i of class c + 1 is row i + 1 - c of the 2x upsample
    before the window shift (UA3 / UB3 are its rows [2 - (c + 1), ...)), so
    the extended rows are class 2's n rows and class 0's last two."""
    return (np.concatenate([col[2], col[0][-2:]]).astype(np.int32),
            np.concatenate([w[2], w[0][-2:]]).astype(np.float32))


def tile_windows(col: np.ndarray, rows: int) -> np.ndarray:
    """Per tile of `rows` extended rows of a table `col` (n + 2, 2)
    (`ext_taps`), the slab columns they read, clamp included: (tiles, 2)
    int32, the first column and the count."""
    out = []
    for i in range(0, col.shape[0], rows):
        c = col[i:i + rows]
        out.append((int(c.min()), int(c.max()) - int(c.min()) + 1))
    return np.asarray(out, np.int32).reshape(-1, 2)


def _class_of(axis: int) -> np.ndarray:
    """Per direction k, the class c + 1 of its component along `axis`."""
    return np.asarray([(lat.C_X, lat.C_Y, lat.C_Z)[axis][k] + 1 for k in range(27)])


def iface_mm_plan_to(plan: Optional[Dict], device) -> Optional[Dict]:
    """The plan with, per group, the device tensors interface_planes_pair_mm
    and extract_endpoint_slabs use:

      "idx"        int64 (2 nf,)      the slab planes of each face's normal
                                      lerp, as parent indices along the normal
      "w_lo/w_hi"  float32 (nf,)      their weights
      "taps"       `iface_taps` as tensors, for the ghost planes' CUDA
                                      kernels (`ops/ghost_planes.py`)
      "ext"        the tap tables by extended row (`ext_taps`), for the
                                      fused build: "row_a" int32 and "w_a"
                                      float32 (A + 2, 2), "row_b", "w_b"
                                      (B + 2, 2)
      "win_a/win_b" int32 (tiles, 2)  per tile of the fused build along A
                                      and B, its staged window of slab
                                      columns (`tile_windows`)

    with each group's "tile" (`build_tiles`), the plan's "threads" (a
    block's) and "tile_cells", the largest staged window's cells; and, off
    a card (`iface_mm_matrices`: a card runs the kernel, and its
    checks add them where they run the plain version)

      "UA", "UBt"  float32 (27, A, wa), (27, wb, B): UA3 and UB3 transposed,
                                      picked per direction k by its classes
      "UA_class", "UBt_class" the same per class, (3, A, wa) and (3, wb,
                                      B), for rho and vel

    beside the numpy arrays of build_iface_mm_plan, and the direction
    components and weights on the (cz, cy, cx, A, B) axes of the planes'
    tail ("cx", "cy", "cz", "W")."""
    if plan is None:
        return None
    cv = torch.tensor([-1.0, 0.0, 1.0], device=device)
    tail = {"cx": cv.view(3, 1, 1), "cy": cv.view(3, 1, 1, 1),
            "cz": cv.view(3, 1, 1, 1, 1),
            "W": torch.as_tensor(lat.W, device=device).view(3, 3, 3, 1, 1)}
    groups = []
    tiles = build_tiles(plan["groups"])
    cells = 0
    for grp, (ta, tb) in zip(plan["groups"], tiles):
        ax = grp["axis"]
        idx = [st3[ax] + i for st3, (i0, i1, _) in zip(grp["starts"], grp["lerp_idx"])
               for i in (i0, i1)]
        wf = np.asarray([w for _, _, w in grp["lerp_idx"]], np.float32)
        taps = iface_taps(grp)
        row_a, w_a = ext_taps(taps["col_a"], taps["w_a"])
        row_b, w_b = ext_taps(taps["col_b"], taps["w_b"])
        win_a, win_b = tile_windows(row_a, ta), tile_windows(row_b, tb)
        cells = max(cells, int(win_a[:, 1].max()) * int(win_b[:, 1].max()))
        ext = {"row_a": row_a, "w_a": w_a, "row_b": row_b, "w_b": w_b}
        groups.append({
            **grp,
            "idx_list": tuple(int(i) for i in idx),
            "idx": torch.as_tensor(idx, dtype=torch.int64, device=device),
            "w_lo": torch.as_tensor(1.0 - wf, device=device),
            "w_hi": torch.as_tensor(wf, device=device),
            "taps": {key: torch.as_tensor(v, device=device) for key, v in taps.items()},
            "ext": {key: torch.as_tensor(v, device=device) for key, v in ext.items()},
            "tile": (ta, tb),
            "win_a": torch.as_tensor(win_a, device=device),
            "win_b": torch.as_tensor(win_b, device=device),
        })
    plan = {**plan, "groups": groups, "tile_cells": cells,
            "threads": min(min(ta * tb for ta, tb in tiles), 128), **tail}
    return plan if torch.device(device).type == "cuda" else iface_mm_matrices(plan)


def iface_mm_matrices(plan: Optional[Dict]) -> Optional[Dict]:
    """A device plan (`iface_mm_plan_to`) with the plain contraction's
    matrices ("UA", "UBt", "UA_class", "UBt_class") on its device, where it
    lacks them: a card's plan, whose checks run the plain version."""
    if plan is None or all("UA" in g for g in plan["groups"]):
        return plan
    groups = []
    for grp in plan["groups"]:
        device = grp["idx"].device
        t0, t1 = [a for a in range(3) if a != grp["axis"]]
        UA3 = torch.as_tensor(grp["UA3"], device=device)
        UB3t = torch.as_tensor(grp["UB3"], device=device).transpose(1, 2).contiguous()
        groups.append({
            **grp,
            "UA": UA3[torch.as_tensor(_class_of(t0), device=device)].contiguous(),
            "UBt": UB3t[torch.as_tensor(_class_of(t1), device=device)].contiguous(),
            "UA_class": UA3, "UBt_class": UB3t,
        })
    return {**plan, "groups": groups}


def extract_endpoint_slabs(plan: Dict, state: Dict) -> List[Dict]:
    """The endpoint slabs of ONE parent state for interface_planes_pair_mm,
    per group of the device plan (`iface_mm_plan_to`): the parent window
    of each face, normal-lerped, float32:

      {"f": (nf, 27, wa, wb), "rho": (nf, wa, wb), "vel": (nf, 3, wa, wb),
       "g": whether f holds bf16 storage's g = f - w}

    A bf16 state's slabs hold g: the decode +w commutes with every
    row-sum-1 operator after it, so interface_planes_pair_mm applies it once
    after its contraction.  The scheduler carries one parent step's slabs
    as the next step's old ones (reference: dense_step.py:577-627,
    solver_dense.py:478-497)."""
    def window(grp, key, lead):
        ax = grp["axis"]
        t0, t1 = [a for a in range(3) if a != ax]
        a = state[key].narrow(lead + t0, grp["starts"][0][t0], grp["sizes"][t0])
        a = a.narrow(lead + t1, grp["starts"][0][t1], grp["sizes"][t1])
        return a.index_select(lead + ax, grp["idx"])

    return endpoint_slabs_from(plan, window, state["f"].dtype == torch.bfloat16)


def endpoint_slabs_from(plan: Dict, window, g: bool) -> List[Dict]:
    """extract_endpoint_slabs with the parent's window given:
    window(grp, key, lead) is the parent field `key` (`lead` leading axes)
    narrowed to the group's transverse window and index-selected along its
    normal at grp["idx"], a contiguous tensor; `g` says whether f holds
    bf16 storage's g.  A sharded parent assembles the window from its slabs
    (parallel.patch_shard.endpoint_slabs_sharded): the same values in the
    same shape, so the same slabs bit for bit."""
    out = []
    for grp in plan["groups"]:
        ax = grp["axis"]
        nf = len(grp["faces"])

        def one(key, lead, _ax=ax, _grp=grp):
            # (2 nf) planes along the normal, moved in front: (nf, 2, ..., wa, wb)
            a = window(_grp, key, lead).movedim(lead + _ax, 0)
            a = a.unflatten(0, (nf, 2))
            wsh = (nf,) + (1,) * (a.dim() - 2)
            # float32 weights promote a bf16 slab to float32 exactly
            return a[:, 0] * _grp["w_lo"].view(wsh) + a[:, 1] * _grp["w_hi"].view(wsh)

        out.append({"f": one("f", 1), "rho": one("rho", 0), "vel": one("vel", 1),
                    "g": g})
    return out


def interface_planes_pair_mm(
    plan: Dict,
    patch: PatchLevel,
    parent: PatchLevel,
    slabs_old: Optional[List[Dict]],
    slabs_new: List[Dict],
    use_temporal: bool,
    g_shifted: bool = False,
    out_dtype=torch.float32,
) -> Dict[int, torch.Tensor]:
    """Ghost planes of both child sub-steps of one parent step from the
    parent's endpoint slabs (extract_endpoint_slabs) and the device plan
    (iface_mm_plan_to; a card's plan gets its matrices here,
    `iface_mm_matrices`): temporal blend at weights (0.0, 0.5), 2x upsample
    with the edge clamp and the per-direction window shift (two batched
    matmuls per field), then equilibrium split and f_neq rescale clamped
    to [0.01, 100] (reference: interface_planes_pair_mm,
    open_ludwig_tpu/ops/dense_step.py:630-858; src/physics_interpolation.jl:
    16-138).  Returns face -> (nw, 27, A, B) contiguous, nw = 2 with
    temporal interpolation (sub-step n reads plane[n]) else 1: pre-shifted
    (plane[n, k, a, b] is the value for destination cell (a, b)), in g =
    f - w space with `g_shifted`, else f-space, cast to `out_dtype`.  The
    contraction runs slab -> UB -> UA, so no intermediate exceeds 4/3 of
    the output planes (`_check_intermediate`)."""
    scale = _fneq_scale(patch, parent)
    blend = use_temporal and slabs_old is not None
    plan = iface_mm_matrices(plan)
    out = {}
    for gi, grp in enumerate(plan["groups"]):
        ax = grp["axis"]
        nf = len(grp["faces"])
        A, B = grp["A"], grp["B"]
        new = slabs_new[gi]

        def pair(key, _gi=gi, _new=new):
            n = _new[key]
            if not blend:
                return n.unsqueeze(1)
            o = slabs_old[_gi][key]
            return torch.stack([o, (o + n) * 0.5], dim=1)

        f_sl = pair("f")  # (nf, nw, 27, wa, wb)
        rv = torch.cat([pair("vel"), pair("rho").unsqueeze(2)], dim=2)  # (nf, nw, 4, wa, wb)
        nw = f_sl.shape[1]
        # f: per direction k, UA3[c_a(k)] @ slab_k @ UB3[c_b(k)]^T
        t = torch.matmul(f_sl, grp["UBt"])  # (nf, nw, 27, wa, B)
        f_up = torch.matmul(grp["UA"], t)  # (nf, nw, 27, A, B)
        # rho and vel: every (c_a, c_b) class pair
        trv = torch.matmul(rv.unsqueeze(3), grp["UBt_class"])  # (nf, nw, 4, 3 [c_b], wa, B)
        # (nf, nw, 4, 3 [c_a], 3 [c_b], A, B)
        rv_w = torch.matmul(grp["UA_class"].unsqueeze(1), trv.unsqueeze(3))
        _check_intermediate((f_sl, t, f_up, rv, trv, rv_w), 36 * nf * nw * A * B)
        # onto the direction classes (cz, cy, cx) of k = (cx+1) + 3(cy+1) + 9(cz+1):
        # c_b's axis before c_a's, a unit axis for the normal's component
        rv_w = rv_w.transpose(3, 4).unsqueeze(5 - ax)  # (nf, nw, 4, z, y, x, A, B)
        ux, uy, uz, rho = rv_w.unbind(2)
        W_b = plan["W"]
        cu = plan["cx"] * ux + plan["cy"] * uy + plan["cz"] * uz
        usq = ux * ux + uy * uy + uz * uz
        expr = rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
        f_up = f_up.view(nf, nw, 3, 3, 3, A, B)
        g_store = new["g"]
        if g_shifted:
            # plane_g = feq_g + (g_up - feq_g) * scale, feq_g = w (expr - 1)
            feq = W_b * (expr - 1.0)
            up = f_up if g_store else f_up - W_b
        else:
            feq = W_b * expr
            up = f_up + W_b if g_store else f_up
        plane = (feq + (up - feq) * scale).to(out_dtype).reshape(nf, nw, 27, A, B)
        for i, face in enumerate(grp["faces"]):
            out[face] = plane[i]
    return out


def _check_intermediate(parts, bound: int) -> None:
    """The contraction's tensors stay within `bound` values: its rho and vel
    output, 4 fields x 9 class pairs x A x B per face and weight, 4/3 of
    the f planes.  Contracted slab -> UB -> UA they do; the reference's
    three-operand einsum specs (dense_step.py:565-575) contracted left to
    right, as torch.einsum does without opt_einsum, would first form the
    outer product of UA3 and UB3: 9 A wa B wb values."""
    big = max(p.numel() for p in parts)
    if big > bound:
        raise AssertionError(f"interface contraction: a tensor of {big} values "
                             f"exceeds its bound of {bound}")


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


def _roll_flat(a: torch.Tensor, cx: int, cy: int, cz: int) -> torch.Tensor:
    """The same shift with (y, z) as one flat axis n = y * Z + z: an x roll
    by cx and one roll by cy * Z + cz over n.  Cells whose source wraps
    (across an x end, a z row or the y ends) lie on the face rows of the
    shift's direction, which the boundary masks overwrite
    (ops/pallas_step.py:2266-2311)."""
    X, Y, Z = a.shape[-3:]
    if cx:
        a = torch.roll(a, cx, dims=-3)
    s = cy * Z + cz
    if s:
        lead = a.shape[:-2]
        a = torch.roll(a.reshape(lead + (Y * Z,)), s, dims=-1).reshape(
            lead + (Y, Z))
    return a


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


def stream_collide_flat_plain(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f-space
    vel: torch.Tensor,  # (3, X, Y, Z)
    u_inlet,
    t_seed: int,
    static: Dict,
    patch: PatchLevel,
    **kw,
):
    """K4's plain version: dense_stream_collide with the flat-(y,z) index
    algebra of make_pallas_step_flat (pallas_step.py:2266-2350): one roll
    over the flattened (Y * Z) axis per slot, then the boundary masks in the
    order z -> y -> x, and velocity neighbours clamped to the cell itself at
    every face.  Only interface-free levels qualify: an interface ghost row
    would not overwrite the wrapped values.  `edges` and `x_off` in `kw`:
    the slab form (dense_stream_collide)."""
    if BC_INTERFACE in patch.face_bc:
        raise ValueError("the flat step needs a level without interface faces")
    return _stream_collide(_roll_flat, f, vel, u_inlet, t_seed, static, patch,
                           **kw)


def stream_collide_inplace_plain(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w
    vel: torch.Tensor,
    u_inlet,
    t_seed: int,
    static: Dict,
    patch: PatchLevel,
    **kw,
):
    """K5's plain version: dense_stream_collide, then the result copied
    into `f` (storage dtype), which is returned with fresh rho and vel.
    `edges` (f_edges in f's storage type) and `x_off` in `kw`: the slab
    form (dense_stream_collide)."""
    if BC_INTERFACE in patch.face_bc:
        raise ValueError("the in-place step needs a level without interface faces")
    edges = kw.pop("edges", None)
    if edges is not None:
        edges = (decode_f(edges[0]), edges[1])
    fo, rho, vo = dense_stream_collide(decode_f(f), vel, u_inlet, t_seed,
                                       static, patch, edges=edges, **kw)
    if f.dtype == torch.bfloat16:
        fo = encode_f(fo, STORE_BF16)
    f.copy_(fo)
    return f, rho, vo


def build_bouzidi_dense_plan(patch: PatchLevel, q_min: float) -> Optional[Dict]:
    """Dense sub-box Bouzidi plan (numpy): the bounding box of the boundary
    cells plus a one-cell halo, clipped to the level, and one signed
    coefficient array S (27, bx, by, bz):

      val = |S| f*[k](cell) + (1-|S|) (f*[opp k](cell) if S < 0
                                       else f*[k](cell + c_opp))

    written into slot opp(k); S's sign encodes the q >= 0.5 branch and S = 0
    means no link (reference: src/bouzidi_kernel.jl:38-88).  The JAX
    package additionally aligns the box to the TPU's (8, 128) tile; the
    port keeps the tight box.  The plan also holds the level's shape and
    the link list K2 runs over (`bouzidi_links`).  Returns None without a
    link."""
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
    return {"lo": lo, "dim": bdim, "level": (X, Y, Z), "S": S,
            "links": bouzidi_links(S, lo, (X, Y, Z))}


SELF_LINK = 0x80  # bit of a link's `code`: `other` is slot j of the cell itself


def _box_links(linked: np.ndarray, lo, level):
    """The linked slots of a (27, bx, by, bz) box at `lo` of an (X, Y, Z)
    level, by slot j (ascending, 13 skipped), then by cell: yields (j,
    (ix, iy, iz) box indices of link direction k = opp(j), cell, far) with
    `far` the cell the box sweep's shifted read takes, cell - c_k wrapped
    inside the box; cells and far cells are level indices.  A cell index
    fits 32 bits; 27 N does not above 79.5M cells, so the kernels form
    j N + cell in 64 bits."""
    lx, ly, lz = lo
    bx, by, bz = linked.shape[1:]
    X, Y, Z = level
    if X * Y * Z >= 2 ** 31:
        raise ValueError(f"level {level}: cell indices exceed int32")
    for j in range(27):
        if j == 13:
            continue
        k = int(lat.OPP[j])  # the link direction writing into slot j
        ix, iy, iz = np.nonzero(linked[k])  # lexicographic: ascending cells
        cell = ((lx + ix) * Y + (ly + iy)) * Z + (lz + iz)
        nx = (ix - int(lat.C_X[k])) % bx
        ny = (iy - int(lat.C_Y[k])) % by
        nz = (iz - int(lat.C_Z[k])) % bz
        far = ((lx + nx) * Y + (ly + ny)) * Z + (lz + nz)
        yield j, (k, ix, iy, iz), cell, far


def _cat(parts, dtypes) -> List[np.ndarray]:
    return [np.concatenate([p[i] for p in parts]).astype(dt) if parts
            else np.zeros(0, dt) for i, dt in enumerate(dtypes)]


def bouzidi_links(S: np.ndarray, lo, level) -> Dict[str, np.ndarray]:
    """K2's list of the linked slots of a plan's S box: one entry per
    (cell, slot j) with S[opp j](cell) != 0, sorted by slot, then by cell,
    so that a warp's reads and stores run along z.  numpy arrays:

      cell  int32    the cell, an index into the (X, Y, Z) level
      code  uint8    j, | SELF_LINK where S < 0
      src   int32    the cell `other` is read at: the cell itself (slot j)
                     where S < 0, else (slot k = opp j) the cell the box
                     sweep reads, cell - c_k wrapped inside the box
      a     float32  |S|

    so that  f_j(cell) = a f*_k(cell) + (1 - a) other  reads every value
    the box sweep (`apply_bouzidi_dense`) reads."""
    parts = []
    for j, idx, cell, far in _box_links(S != 0, lo, level):
        s = S[idx]
        self_ = s < 0
        parts.append((cell, np.where(self_, SELF_LINK | j, j), np.where(self_, cell, far),
                      np.abs(s)))
    cat = _cat(parts, (np.int32, np.uint8, np.int32, np.float32))
    return dict(zip(("cell", "code", "src", "a"), cat))


def bouzidi_ab_links(A: np.ndarray, B: np.ndarray, lo, level) -> Dict[str, np.ndarray]:
    """K6's list of the linked slots of the two-array encoding: one entry
    per (cell, slot j) with A[opp j](cell) > 0, sorted by slot, then by
    cell, as K2's (`bouzidi_links`).  numpy arrays:

      cell  int32    the cell, an index into the (X, Y, Z) level
      j     uint8    the slot written
      far   int32    cell - c_k (k = opp j) wrapped inside the box, the cell
                     the box sweep's shifted read takes; the sign of B
                     chooses between it and slot j of the cell itself
      A, B  float32  the link's coefficients as given (the wrapper's plan
                     holds them in the storage dtype)

    so that  f_j(cell) = A f*_k(cell) + |B| (f*_j(cell) if B < 0 else
    f*_k(far))  reads every value the box sweep (`apply_bouzidi_ab_plain`)
    reads."""
    parts = [(cell, np.full(len(cell), j), far, A[idx], B[idx])
             for j, idx, cell, far in _box_links(A > 0, lo, level)]
    cat = _cat(parts, (np.int32, np.uint8, np.int32, np.float32, np.float32))
    return dict(zip(("cell", "j", "far", "A", "B"), cat))


def bouzidi_plan_to(plan: Optional[Dict], device) -> Optional[Dict]:
    """A plan with S and its links as tensors on `device`, and the links'
    float32 scratch (one value per link, K2's between its two phases)."""
    if plan is None:
        return None
    links = {key: torch.as_tensor(v, device=device) for key, v in plan["links"].items()}
    links["scratch"] = torch.empty(links["a"].shape, dtype=torch.float32, device=device)
    return {**plan, "S": torch.as_tensor(plan["S"], device=device), "links": links}


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


def apply_bouzidi_links(f_out: torch.Tensor, plan: Dict,
                        halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bouzidi correction of (27, X, Y, Z) f over the plan's link list (K2's
    plain version), returned as a new tensor: every link's inputs gathered
    from the uncorrected f, then every value scattered.  Equal bit for bit
    to `apply_bouzidi_dense` (the same float32 expression on the same
    values), on float32 f and bf16 g alike.  With `halo` (f's dtype), f is
    one x slab and a link with src = -1 - h reads its `other` from halo[h],
    the uncorrected value gathered from another slab (K2's sharded form)."""
    links = plan["links"]
    dev = f_out.device
    cell, code, src = (torch.as_tensor(links[key], device=dev).long()
                       for key in ("cell", "code", "src"))
    a = torch.as_tensor(links["a"], device=dev)
    N = f_out[0].numel()
    j = code & 31
    k = 26 - j
    oslot = torch.where(code >= SELF_LINK, j, k)
    flat = f_out.reshape(-1)
    fk = flat[k * N + cell].float()
    if halo is None or halo.numel() == 0:
        other = flat[oslot * N + src].float()
    else:
        own = src >= 0
        other = torch.where(own, flat[oslot * N + src.clamp(min=0)],
                            halo[(-1 - src).clamp(min=0)]).float()
    val = (a * fk + (1.0 - a) * other).to(f_out.dtype)
    out = f_out.clone()
    out.view(-1)[j * N + cell] = val
    return out


def bouzidi_ab_from_S(S) -> Tuple[np.ndarray, np.ndarray]:
    """The retired two-array encoding (A, B) of a signed S box
    (tools/probe_bz_encoding.py:59-62): A = |S|, B = sign(S)(1 - |S|), and
    B = 0 where S = 1 (the folded fallback, whose other weight is 0).
    float32 numpy arrays."""
    S = np.asarray(S, np.float32)
    A = np.abs(S)
    B = np.where(S < 0, -(1.0 - A), np.where(S > 0, 1.0 - A, 0.0)).astype(np.float32)
    B[S == 1.0] = 0.0
    return A, B


def bouzidi_ab_plan(plan: Dict, dtype) -> Dict:
    """The plan's box with its S recoded as the two arrays A and B, boxes
    of `dtype` on S's device, and K6's link list of them
    (`bouzidi_ab_links`: cell, j and far as int32 / uint8 tensors, A and B
    per link in `dtype`) with a float32 scratch, as K2's plan carries its
    links (`bouzidi_plan_to`)."""
    S = plan["S"]
    dev = S.device if isinstance(S, torch.Tensor) else torch.device("cpu")
    S = S.cpu().numpy() if isinstance(S, torch.Tensor) else np.asarray(S)
    A, B = (torch.as_tensor(v).to(dtype) for v in bouzidi_ab_from_S(S))
    # the link set and coefficients as the storage dtype holds them
    links = bouzidi_ab_links(A.float().numpy(), B.float().numpy(), plan["lo"],
                             plan["level"])
    links = {key: torch.as_tensor(v).to(device=dev, dtype=dtype if key in ("A", "B") else None)
             for key, v in links.items()}
    links["scratch"] = torch.empty(links["cell"].shape, dtype=torch.float32, device=dev)
    return {"lo": plan["lo"], "dim": plan["dim"], "level": plan["level"],
            "A": A.to(dev), "B": B.to(dev), "links": links}


def apply_bouzidi_ab_plain(f_out: torch.Tensor, plan: Dict) -> torch.Tensor:
    """Bouzidi correction of (27, X, Y, Z) with the two-array coefficients
    as the box sweep of the TPU kernel of tools/probe_bz_encoding.py:76-136
    performs it, returned as a new tensor: the reference that
    `apply_bouzidi_ab_links` (K6's plain version) is held to.  plan["A"]
    and plan["B"] are (27, bx, by, bz) tensors on f's device, in any float
    dtype (the probe passes the storage dtype); per slot j with k = opp(j),
    where A_k > 0:

      f_j = A_k f*_k + |B_k| (f*_j if B_k < 0 else f*_k(cell + c_opp k))

    computed in float32 and stored in f's dtype."""
    def link(k):
        a = plan["A"][k].float()
        b = plan["B"][k].float()
        return a, b.abs(), b < 0, a > 0

    return _bouzidi_box(f_out, plan, link)


def apply_bouzidi_ab_links(f_out: torch.Tensor, plan: Dict) -> torch.Tensor:
    """Bouzidi correction of (27, X, Y, Z) f over the two-array plan's link
    list (K6's plain version), returned as a new tensor: every link's
    inputs gathered from the uncorrected f, then every value scattered.
    Equal bit for bit to `apply_bouzidi_ab_plain` (the same float32
    expression on the same values), on float32 f and bf16 g alike."""
    links = plan["links"]
    dev = f_out.device
    cell, j, far = (torch.as_tensor(links[key], device=dev).long()
                    for key in ("cell", "j", "far"))
    a, b = (torch.as_tensor(links[key], device=dev).float() for key in ("A", "B"))
    N = f_out[0].numel()
    k = 26 - j
    flat = f_out.reshape(-1)
    other = torch.where(b < 0, flat[j * N + cell].float(), flat[k * N + far].float())
    val = (a * flat[k * N + cell].float() + b.abs() * other).to(f_out.dtype)
    out = f_out.clone()
    out.view(-1)[j * N + cell] = val
    return out


def fused_pair_plain(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w
    vel: torch.Tensor,  # (3, X, Y, Z)
    u: Tuple[float, float],  # (u_a, u_b)
    seed: Tuple[int, int],  # (seed_a, seed_b)
    static: Dict,
    patch: PatchLevel,
    plan: Optional[Dict],
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    iface_a: Optional[Dict[int, torch.Tensor]] = None,
    iface_b: Optional[Dict[int, torch.Tensor]] = None,
):
    """Step A -> storage dtype -> Bouzidi (if `plan`) -> step B, returning
    step B's (f, rho, vel) with f in the storage dtype and uncorrected, as
    the fused kernel leaves it (reference: pallas_step.py:1001-1007)."""
    kw = dict(c_wale=c_wale, nu_sgs_background=nu_sgs_background,
              inlet_turbulence=inlet_turbulence, wall_model=wall_model,
              sponge_blend=sponge_blend)
    bf16 = f.dtype == torch.bfloat16
    fa, _, va = dense_stream_collide(decode_f(f), vel, u[0], seed[0], static,
                                     patch, iface=iface_a, **kw)
    if bf16:
        fa = encode_f(fa, STORE_BF16)
    if plan is not None:
        fa = apply_bouzidi_dense(fa, plan)
    fb, rb, vb = dense_stream_collide(decode_f(fa), va, u[1], seed[1], static,
                                      patch, iface=iface_b, **kw)
    if bf16:
        fb = encode_f(fb, STORE_BF16)
    return fb, rb, vb

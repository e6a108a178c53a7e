"""The ghost planes of a child level on the card: hand-written CUDA
kernels (csrc/ghost_planes.cu) in place of the plain versions' ~170 small
PyTorch launches a child build.

  - `build(plan, ..., old, new, ...)` is the whole build in one launch
    from the parent's states before (`old`) and after (`new`) its step:
    the planes `planes` makes from `extract_slabs` of the two states, bit
    for bit, with no slab in device memory.  One block a tile of a face's
    plane and normal class of the directions stages its window of the
    lerped slab, old and blend, in shared memory and makes the tile's
    planes from it; the plan's "tile" (`dense_step.build_tiles`, 8 x 16,
    16 x 16 on the z faces of the larger builds) keeps the smallest child
    of the benchmark's cells at over two blocks a SM.  The scheduler takes
    it wherever the parent steps A -> B on one card (K1 or K4), whose
    pre-step state lies in its own buffers until the child has read it;
  - `extract_slabs(plan, state)` is `dense_step.extract_endpoint_slabs` in
    one launch: the endpoint slabs of every interface-face group of the
    child in one float32 buffer, the plain version's values bit for bit;
    each group's "f", "rho" and "vel" are views of it, and "buf" is the
    buffer;
  - `planes(...)` is `dense_step.interface_planes_pair_mm` in one launch
    over every group, face and temporal weight: the temporal blend, the
    2x upsample with the edge clamp and the per-direction window shift
    (the plan's tap tables, `dense_step.iface_taps`), rho and u at each
    direction's shifted position, the equilibrium split and the f_neq
    rescale, the bf16 decode and g form, the cast to the child's storage
    type; within float32 round-off of the plain version.  It reads slabs
    of either origin: this extraction's, or the x-slab path's assembled
    ones (`parallel.patch_shard.endpoint_slabs_sharded`), which have the
    same shapes and are copied contiguous first.
These two run under a K5 parent, whose in-place step overwrites the old
state, and under the x mesh; the graphed runner's carry of the new slabs
into the old (`solver_dense.FixedBuffers.carry`) copies the one buffer, so
such a child build is three device operations, and a fused one is one.

All take CUDA tensors only; the scheduler (`solver_dense.
make_coarse_step_dense`) runs the plain versions on the CPU, decided by
the tensors' device, and counts each child build (`spans.COUNTS`
"planes.fused", "planes.kernel" or "planes.plain").  Their launches are
counted here, at the launch, in `LAUNCHES` ("ghost_extract",
"ghost_planes", "ghost_build"), kept apart from `cuda_step.LAUNCHES`,
which holds the kernels a coarse step's stream-collide and Bouzidi work
needs; as there, a launch under capture counts in `CAPTURED` too and a
graph's replays add its captured launches to `REPLAYED`
(`graphs.GraphSet`), so `executed_launches()` is what ran on the card.
What bounds them and their design: the source's head comment.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from ..core.patch import PatchLevel
from .cuda_step import _check, _lib, _on_card, _raise_on
from .dense_step import _fneq_scale

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_EXTRACT_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
_PLANES_ARGTYPES = [_I, _I, _P, _P, _I, _I, _I, _I, _F, _P]
_BUILD_ARGTYPES = [_I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P]

LAUNCHES: Dict[str, int] = {"ghost_extract": 0, "ghost_planes": 0, "ghost_build": 0}
CAPTURED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)  # of LAUNCHES, under capture
REPLAYED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)  # captured x replays


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CAPTURED[k] = REPLAYED[k] = 0


def executed_launches() -> Dict[str, int]:
    """Launches run on the card since the last reset: the eager ones and the
    captured ones times their graphs' replays."""
    return {k: LAUNCHES[k] - CAPTURED[k] + REPLAYED[k] for k in LAUNCHES}


def _count(name: str) -> None:
    LAUNCHES[name] += 1
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1


def _window(grp: Dict):
    """(axis, t0, t1, nf, wa, wb) of a plan group."""
    ax = grp["axis"]
    t0, t1 = [a for a in range(3) if a != ax]
    return ax, t0, t1, len(grp["faces"]), grp["sizes"][t0], grp["sizes"][t1]


def extract_slabs(plan: Dict, state: Dict) -> List[Dict]:
    """`dense_step.extract_endpoint_slabs` of one parent state on the card,
    one launch: per group {"f": (nf, 27, wa, wb), "rho": (nf, wa, wb),
    "vel": (nf, 3, wa, wb), "g": whether f holds bf16 storage's g, "buf":
    the float32 buffer every group's slabs are views of}."""
    f, rho, vel = state["f"], state["rho"], state["vel"]
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"extract_slabs: CUDA tensors only, got {dev}")
    dims = tuple(rho.shape)
    _check(f, "f", (27,) + dims, (torch.float32, torch.bfloat16), dev)
    _check(rho, "rho", dims, (torch.float32,), dev)
    _check(vel, "vel", (3,) + dims, (torch.float32,), dev)
    gi, gw, parts = [], [], []
    off = 0
    for grp in plan["groups"]:
        ax, t0, t1, nf, wa, wb = _window(grp)
        sa, sb = grp["starts"][0][t0], grp["starts"][0][t1]
        idx = list(grp["idx_list"])
        if (sa < 0 or sb < 0 or sa + wa > dims[t0] or sb + wb > dims[t1]
                or min(idx) < 0 or max(idx) >= dims[ax]):
            raise ValueError(f"extract_slabs: group {ax}'s window lies outside the "
                             f"parent {dims}")
        gi += [ax, nf, wa, wb, sa, sb] + idx + [0] * (4 - len(idx)) + [off]
        for _, _, wf in grp["lerp_idx"]:
            gw += [1.0 - wf, wf]
        gw += [0.0, 0.0] * (2 - nf)
        parts.append((off, nf, wa, wb))
        off += nf * 31 * wa * wb
    buf = torch.empty(off, dtype=torch.float32, device=dev)
    with _on_card(dev):
        rc = _lib("ghost_planes", "ol_ghost_extract", _EXTRACT_ARGTYPES)(
            int(f.dtype == torch.bfloat16), f.data_ptr(), rho.data_ptr(), vel.data_ptr(),
            buf.data_ptr(), *dims, len(parts), (ctypes.c_int * len(gi))(*gi),
            (ctypes.c_float * len(gw))(*gw), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ghost_extract")
    _count("ghost_extract")
    g = f.dtype == torch.bfloat16
    out = []
    for o, nf, wa, wb in parts:
        n = nf * wa * wb
        out.append({"f": buf[o:o + 27 * n].view(nf, 27, wa, wb),
                    "rho": buf[o + 27 * n:o + 28 * n].view(nf, wa, wb),
                    "vel": buf[o + 28 * n:o + 31 * n].view(nf, 3, wa, wb),
                    "g": g, "buf": buf})
    return out


def planes(plan: Dict, patch: PatchLevel, parent: PatchLevel,
           slabs_old: Optional[List[Dict]], slabs_new: List[Dict], use_temporal: bool,
           g_shifted: bool = False, out_dtype=torch.float32) -> Dict[int, torch.Tensor]:
    """`dense_step.interface_planes_pair_mm` on the card, one launch: face ->
    (nw, 27, A, B) contiguous, nw = 2 with the temporal blend (sub-step n
    reads plane[n]) else 1, pre-shifted, g = f - w with `g_shifted`, in
    `out_dtype` (float32 or bfloat16); every face's planes are views of
    one buffer.  Slabs that are not contiguous (the plain extraction's)
    are copied contiguous first."""
    dev = slabs_new[0]["f"].device
    if dev.type != "cuda":
        raise ValueError(f"planes: CUDA tensors only, got {dev}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes: out_dtype {out_dtype}, expected float32 or bfloat16")
    blend = bool(use_temporal and slabs_old is not None)
    nw = 2 if blend else 1
    g_store = slabs_new[0]["g"]
    sets = [slabs_new] + ([slabs_old] if blend else [])
    if any(len(s) != len(plan["groups"]) or any(sl["g"] != g_store for sl in s)
           for s in sets):
        raise ValueError("planes: the slabs are not the plan's groups of one storage type")
    total = sum(len(g["faces"]) * nw * 27 * g["A"] * g["B"] for g in plan["groups"])
    buf = torch.empty(total, dtype=out_dtype, device=dev)
    ptrs, gi, out = [], [], {}
    keep = []  # the slabs as the kernel reads them, alive until the launch
    off = 0
    for i, grp in enumerate(plan["groups"]):
        ax, _, _, nf, wa, wb = _window(grp)
        A, B = grp["A"], grp["B"]
        new = {key: slabs_new[i][key].contiguous() for key in ("f", "rho", "vel")}
        old = ({key: slabs_old[i][key].contiguous() for key in ("f", "rho", "vel")}
               if blend else None)
        for sl in (new, old) if blend else (new,):
            _check(sl["f"], "slab f", (nf, 27, wa, wb), (torch.float32,), dev)
            _check(sl["rho"], "slab rho", (nf, wa, wb), (torch.float32,), dev)
            _check(sl["vel"], "slab vel", (nf, 3, wa, wb), (torch.float32,), dev)
            keep.append(sl)
        taps = grp["taps"]
        _check(taps["col_a"], "col_a", (3, A, 2), (torch.int32,), dev)
        _check(taps["w_a"], "w_a", (3, A, 2), (torch.float32,), dev)
        _check(taps["col_b"], "col_b", (3, B, 2), (torch.int32,), dev)
        _check(taps["w_b"], "w_b", (3, B, 2), (torch.float32,), dev)
        n = nf * nw * 27 * A * B
        view = buf[off:off + n].view(nf, nw, 27, A, B)
        off += n
        ptrs += [None if old is None else old[k].data_ptr() for k in ("f", "rho", "vel")]
        ptrs += [new[k].data_ptr() for k in ("f", "rho", "vel")]
        ptrs += [view.data_ptr()] + [taps[k].data_ptr()
                                     for k in ("col_a", "w_a", "col_b", "w_b")]
        gi += [ax, nf, A, B, wa, wb]
        for j, face in enumerate(grp["faces"]):
            out[face] = view[j]
    with _on_card(dev):
        rc = _lib("ghost_planes", "ol_ghost_planes", _PLANES_ARGTYPES)(
            int(out_dtype == torch.bfloat16), len(plan["groups"]),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(gi))(*gi),
            nw, int(blend), int(g_store), int(g_shifted), _fneq_scale(patch, parent),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ghost_planes")
    _count("ghost_planes")
    return out


def _state_ptrs(state: Dict, dims, dtype, dev) -> List[int]:
    _check(state["f"], "f", (27,) + dims, (dtype,), dev)
    _check(state["rho"], "rho", dims, (torch.float32,), dev)
    _check(state["vel"], "vel", (3,) + dims, (torch.float32,), dev)
    return [state[k].data_ptr() for k in ("f", "rho", "vel")]


def build(plan: Dict, patch: PatchLevel, parent: PatchLevel, old: Optional[Dict],
          new: Dict, use_temporal: bool, g_shifted: bool = False,
          out_dtype=torch.float32) -> Dict[int, torch.Tensor]:
    """A child build in one launch from the parent's states before (`old`)
    and after (`new`) its step: `planes(plan, ..., extract_slabs(plan, old),
    extract_slabs(plan, new), ...)` bit for bit, with no slab in device
    memory.  One block a tile of a face's plane (the plan's "tile",
    `dense_step.build_tile`) stages its window of the slab (the plan's
    "win_a" / "win_b") in shared memory and makes the tile's planes from
    it.  face -> (nw, 27, A, B) as `planes` returns; `old` is read only
    with the temporal blend (None without)."""
    f = new["f"]
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"build: CUDA tensors only, got {dev}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"build: out_dtype {out_dtype}, expected float32 or bfloat16")
    blend = bool(use_temporal)
    if blend and old is None:
        raise ValueError("build: the temporal blend reads the old state, got None")
    nw = 2 if blend else 1
    dims = tuple(new["rho"].shape)
    st = (_state_ptrs(old, dims, f.dtype, dev) if blend else [None] * 3)
    st += _state_ptrs(new, dims, f.dtype, dev)
    total = sum(len(g["faces"]) * nw * 27 * g["A"] * g["B"] for g in plan["groups"])
    buf = torch.empty(total, dtype=out_dtype, device=dev)
    ptrs, gi, gw, out = [], [], [], {}
    off = 0
    for grp in plan["groups"]:
        ax, t0, t1, nf, wa, wb = _window(grp)
        A, B = grp["A"], grp["B"]
        sa, sb = grp["starts"][0][t0], grp["starts"][0][t1]
        idx = list(grp["idx_list"])
        if (sa < 0 or sb < 0 or sa + wa > dims[t0] or sb + wb > dims[t1]
                or min(idx) < 0 or max(idx) >= dims[ax]):
            raise ValueError(f"build: group {ax}'s window lies outside the parent {dims}")
        ext = grp["ext"]
        ta, tb = grp["tile"]
        _check(ext["row_a"], "row_a", (A + 2, 2), (torch.int32,), dev)
        _check(ext["w_a"], "w_a", (A + 2, 2), (torch.float32,), dev)
        _check(ext["row_b"], "row_b", (B + 2, 2), (torch.int32,), dev)
        _check(ext["w_b"], "w_b", (B + 2, 2), (torch.float32,), dev)
        _check(grp["win_a"], "win_a", (-(-(A + 2) // ta), 2), (torch.int32,), dev)
        _check(grp["win_b"], "win_b", (-(-(B + 2) // tb), 2), (torch.int32,), dev)
        n = nf * nw * 27 * A * B
        view = buf[off:off + n].view(nf, nw, 27, A, B)
        off += n
        ptrs += [view.data_ptr()] + [ext[k].data_ptr()
                                     for k in ("row_a", "w_a", "row_b", "w_b")]
        ptrs += [grp["win_a"].data_ptr(), grp["win_b"].data_ptr()]
        gi += [ax, nf, A, B, sa, sb] + idx + [0] * (4 - len(idx)) + [ta, tb]
        for _, _, wf in grp["lerp_idx"]:
            gw += [1.0 - wf, wf]
        gw += [0.0, 0.0] * (2 - nf)
        for j, face in enumerate(grp["faces"]):
            out[face] = view[j]
    with _on_card(dev):
        rc = _lib("ghost_planes", "ol_ghost_build", _BUILD_ARGTYPES)(
            int(f.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            (ctypes.c_void_p * 6)(*st), *dims, len(plan["groups"]),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(gi))(*gi),
            (ctypes.c_float * len(gw))(*gw), plan["threads"], plan["tile_cells"],
            int(blend), int(g_shifted), _fneq_scale(patch, parent),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ghost_build")
    _count("ghost_build")
    return out

"""Wrappers of the hand-written CUDA kernels K1 (stream-collide), K2
(Bouzidi), K3 (fused pair), K4 (flat stream-collide), K5 (in-place
stream-collide) and K6 (two-array Bouzidi), with their launch counters.

Each wrapper checks device, dtype, shape and contiguity, then:
  - for CPU tensors runs the kernel's plain PyTorch version
    (ops/dense_step.py) — the path the CPU tests hold against the JAX
    package;
  - for CUDA tensors launches the kernel on torch.cuda.current_stream() and
    raises if the launch fails.  There is no fallback: a build or launch
    failure is an error.
`LAUNCHES` counts kernel launches only (never the plain path), so a run
can show that its main path went through the kernels.  The ghost planes'
kernels (`ops/ghost_planes.py`) have no key in it: they count their
launches in their own `ghost_planes.LAUNCHES`.  A launch made while
a CUDA graph is captured counts there and in `CAPTURED`; the graph's
replays add its captured launches to `REPLAYED` (`graphs.GraphSet`), so
the kernels a run executed are `executed_launches()`: LAUNCHES - CAPTURED
+ REPLAYED.

The steps K1, K3, K4 and K5 take their inlet speed and noise seed either
by value (u_inlet a float, t_seed an int) or from the step record on the
device (u_inlet a `solver.StepRef`, t_seed None): the kernel then reads
both at run time (csrc/lbm_cell.cuh: `inlet_u`, `noise_seed`), so a
captured launch serves every coarse step.  K1, K3, K4 and K5 take `out=`
(preallocated outputs), which a captured step writes at fixed addresses.

K1 `stream_collide` (csrc/stream_collide.cu) replaces the Pallas kernel
make_pallas_step (open_ludwig_tpu/ops/pallas_step.py:247).  It moves ~145 B
per cell per bf16 sub-step and runs at 60-80% of that bound; the design is
one thread per cell, z-fastest coalesced rows read through the read-only
cache, the 27 loads back to back off the level's plane base pointers with
32-bit offsets (the face slots overwritten afterwards), the wall model's
transcendental chain only where the wall distance is in (0, 10), A->B
buffers (no in-place hazard between concurrent CTAs), and g-space math on
bf16 storage so decode/encode are bare casts.  Its interface faces read
ghost planes pre-shifted (27, A, B) in the storage type (bf16 g or float32
f, as the reference's g-native step reads them), so a face slot is one
load at the cell's own plane position.  `tools/probe_k1_sections.py`
times its sections on the card.

K2 `bouzidi` (csrc/bouzidi.cu) replaces make_bouzidi_pallas
(pallas_step.py:62).  Its work is a few hundred kB of linked slots, so a
call is its launch and a few dependent loads: one cooperative launch over
the plan's list of links, which reads every link's inputs, meets every
other block at one grid barrier, and then writes every link in place;
nothing is allocated per call.

K3 `fused_pair` (csrc/fused_pair.cu) replaces make_pallas_step_fused2
(pallas_step.py:961): two sub-steps of a childless level in one pass, step
A's Bouzidi correction between them, step B's output uncorrected (the
caller runs K2 after it).  It reads f once and writes it once per pair,
~154 B per cell in bf16 against ~290 for K1 -> K2 -> K1, and keeps step A
in a ring of four planes in shared memory.  The block is warp-specialised:
producer warps run step A from device memory a plane or two ahead,
consumer warps run step B from the ring, and they meet through named
barriers per ring slot (tests/test_torch_kernel_schedules.py steps the
protocol through random interleavings).
What bounds it is the instructions of ~2.25-2.5 cell updates per pair at
the one block per SM its ring allows, not bytes.  The per-cell physics is
K1's own (csrc/lbm_cell.cuh).

K4 `stream_collide_flat` (csrc/stream_collide_flat.cu) replaces
make_pallas_step_flat (pallas_step.py:2100) on interface-free levels the
reference stores flat (level 1 of a multi-level case): K1's cell body
(csrc/stream_collide_body.cuh), whose flat index with z offsets of +-1 is
the reference's flat-(y, z) view, with the ghost-plane reads compiled out.
Its eager time at the bench case's level 1 (0.2M cells) is the host's
launch; `out=` takes preallocated outputs, so a CUDA graph can replay it.
Its launch shape depends on the storage type and on the level's waves
(`flat_instantiation`, `flat_choice`).

K5 `stream_collide_inplace` (csrc/stream_collide_inplace.cu) replaces the
in-place make_pallas_step_2d (pallas_step.py:1575) on interface-free levels
whose plane exceeds the reference's 1-D window: f is updated in its own
buffer, rho and vel are fresh.  The level is cut into regions of a few
rows, all of z and a run of planes (ops/inplace_layout.py); an edge copy
of the cells that other regions read comes first (~10% of f at 63.7M
cells), then each block walks its region in z-chunks of 128 bytes a row
and marches along x inside a chunk, the old values it has overwritten
kept in shared memory.  Bound like K1, plus its edge traffic and the
lockstep of a block's warps; it saves the second f copy (3.4 GB at 63.7M
cells in bf16).

K1, K4, K5 and K2 also have a sharded form, for one x slab of a level
cut along x over several devices (`parallel/patch_shard.py`; the JAX
package's `shard_nx` kernels, run under shard_map): `edges=(f_edges,
v_edges)` and `x_off=` on the steps, the neighbour slabs' edge planes
(27, 2, Y, Z) in the storage type and (3, 2, Y, Z) float32 and the slab's
first global plane, `halo=` on K2, the values its links read in other
slabs.  Each is the same kernel source with the slab's ends read from
the edges, instantiated apart (the single-device code is unchanged), and
counts its launches under its own name ("..._shard").  Every wrapper
launches on its tensors' card (`torch.cuda.device`).

K6 `bouzidi_ab` (csrc/bouzidi_ab.cu) replaces the Pallas kernel of
tools/probe_bz_encoding.py (:117): the correction with the retired
two-array coefficients (A, B) in the storage dtype, which the probe
(`open_ludwig_torch.tools.probe_bz_encoding`) times against K2.  It runs
K2's launch (csrc/bouzidi_links.cuh) over its own link list
(`dense_step.bouzidi_ab_links`), so the two differ in their encoding alone;
nothing is allocated per call.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from ..core.patch import BC_INTERFACE, PatchLevel
from . import build, storage
from . import inplace_layout as inplace_layout_mod
from .dense_step import (
    apply_bouzidi_ab_links,
    apply_bouzidi_links,
    dense_stream_collide,
    fused_pair_plain,
    stream_collide_flat_plain,
    stream_collide_inplace_plain,
)

LAUNCHES: Dict[str, int] = {"stream_collide": 0, "bouzidi": 0, "fused_pair": 0,
                            "stream_collide_flat": 0, "stream_collide_inplace": 0,
                            "bouzidi_ab": 0, "stream_collide_shard": 0,
                            "bouzidi_shard": 0, "stream_collide_flat_shard": 0,
                            "stream_collide_inplace_shard": 0}
CAPTURED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)  # of LAUNCHES, under capture
REPLAYED: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)  # captured x replays

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# u_inlet, seed, then the step record: its counter and table pointers,
# the table's last index and the sub-step's (dt, shift, k)
_STEP = [_F, _I, _P, _P, _I, _I, _I, _I]
_SC_ARGTYPES = [_I] + [_P] * 14 + [_I] * 5 + [_I] * 6 + _STEP + [_D] * 4 + [_I, _I, _P]
_BZ_ARGTYPES = [_I] + [_P] * 6 + [_I] * 4 + [_P]
_BZAB_ARGTYPES = [_I] + [_P] * 7 + [_I] * 4 + [_P]
_FLAT_ARGTYPES = [_I] + [_P] * 8 + [_I] * 5 + [_I] * 6 + _STEP + [_D] * 4 + [_I, _I, _P]
_IP_ARGTYPES = (
    [_I] + [_P] * 8 + [_I] * 5 + [_I] * 6 + _STEP + [_D] * 4
    + [_I, _I, _I, _I, _I, _P]
)
_SC_SHARD_ARGTYPES = (
    [_I] + [_P] * 16 + [_I] * 2 + [_I] * 5 + [_I] * 6 + _STEP + [_D] * 4
    + [_I, _I, _P]
)
_FLAT_SHARD_ARGTYPES = (
    [_I] + [_P] * 10 + [_I] * 2 + [_I] * 5 + [_I] * 6 + _STEP + [_D] * 4
    + [_I, _I, _P]
)
_IP_SHARD_ARGTYPES = (
    [_I] + [_P] * 7 + [_I] * 2 + [_P] * 3 + [_I] * 5 + [_I] * 6 + _STEP
    + [_D] * 4 + [_I, _I, _I, _I, _I, _P]
)
_BZ_SHARD_ARGTYPES = [_I] + [_P] * 7 + [_I] * 4 + [_P]
_FP_ARGTYPES = (
    [_I] + [_P] * 21 + [_I] * 5 + [_I] * 6 + [_F, _F, _I, _I, _P, _P] + [_I] * 7
    + [_D] * 4 + [_I, _I] + [_I] * 6 + [_P]
)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CAPTURED[k] = REPLAYED[k] = 0


def executed_launches() -> Dict[str, int]:
    """Kernel launches run on the card since the last reset: the eager ones
    and the captured ones times their graphs' replays."""
    return {k: LAUNCHES[k] - CAPTURED[k] + REPLAYED[k] for k in LAUNCHES}


def _count(name: str) -> None:
    LAUNCHES[name] += 1
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1


def _is_ref(u) -> bool:
    return hasattr(u, "record")


def _host_step(u_inlet, t_seed):
    """(u_inlet, t_seed) as host numbers for the plain versions: a step
    record's entry read back (the CPU's record), or the numbers given."""
    return u_inlet.host() if _is_ref(u_inlet) else (u_inlet, t_seed)


def _step_args(u_inlet, t_seed, device) -> list:
    """The C interface's (u, seed, rec_t, rec_u, rec_last, dt, shift, k): a
    step record entry's device pointers and sub-step constants, or the
    numbers by value with no record."""
    if not _is_ref(u_inlet):
        return [float(u_inlet), int(t_seed), None, None, 0, 0, 0, 0]
    rec = u_inlet.record
    if rec.t.device != device or rec.u.device != device:
        raise ValueError(f"step record on {rec.t.device}, the launch on {device}")
    return [0.0, 0, rec.t.data_ptr(), rec.u.data_ptr(), rec.last,
            u_inlet.dt, u_inlet.shift, u_inlet.k]


def _check_out(out, f, vel, XL, Y, Z, dev, what: str, f_in_place: bool = False):
    """Preallocated outputs (f_out, rho, vel_out): f's shape and dtype,
    (XL, Y, Z) and vel's shape float32, on f's device, none aliasing an
    input it must not (an A -> B step's f_out, every step's vel_out); an
    in-place step (K5) takes f_out None or f itself."""
    f_out, rho, vel_out = out
    if f_in_place:
        if f_out is not None and f_out.data_ptr() != f.data_ptr():
            raise ValueError(f"{what}: out f must be None or f itself (in place)")
    else:
        _check(f_out, "out f_out", f.shape, (f.dtype,), dev)
        if f_out.data_ptr() == f.data_ptr():
            raise ValueError(f"{what}: out aliases its input (A -> B buffers)")
    _check(rho, "out rho", (XL, Y, Z), (torch.float32,), dev)
    _check(vel_out, "out vel_out", vel.shape, (torch.float32,), dev)
    if vel_out.data_ptr() == vel.data_ptr():
        raise ValueError(f"{what}: out vel_out aliases vel")


def _put(out, vals):
    """The plain version's results written into preallocated `out` (None
    where the array is updated in place) and returned; `vals` without."""
    if out is None:
        return vals
    res = []
    for t, v in zip(out, vals):
        if t is None:
            res.append(v)
        else:
            t.copy_(v)
            res.append(t)
    return tuple(res)


def _lib(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(build.load(name).lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def _on_card(dev: torch.device):
    """The context in which a launch on `dev` runs: its card current (a
    stream of another card than the current one cannot take the launch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check(t: torch.Tensor, name: str, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_level(f, vel, static: Dict, patch: PatchLevel, edges=None,
                 x_off: int = 0) -> None:
    """f, vel and the statics over the level, or over the x slab of f's
    planes from global plane `x_off` with its edge planes `edges`."""
    X, Y, Z = patch.interior
    dev = f.device
    if edges is not None:
        XL = f.shape[1] if f.dim() == 4 else -1
        if not 0 < XL <= X or not 0 <= x_off <= X - XL:
            raise ValueError(f"slab of {XL} planes from {x_off} outside the "
                             f"level's {X}")
        _check(edges[0], "f_edges", (27, 2, Y, Z), (f.dtype,), dev)
        _check(edges[1], "v_edges", (3, 2, Y, Z), (torch.float32,), dev)
        X = XL
    elif x_off != 0:
        raise ValueError("x_off without edges")
    _check(f, "f", (27, X, Y, Z), (torch.float32, torch.bfloat16), dev)
    _check(vel, "vel", (3, X, Y, Z), (torch.float32,), dev)
    _check(static["obstacle"], "obstacle", (X, Y, Z), (torch.bool,), dev)
    _check(static["sponge"], "sponge", (X, Y, Z), (torch.float32,), dev)
    _check(static["wall_dist"], "wall_dist", (X, Y, Z), (torch.float32,), dev)


def _iface_planes(patch: PatchLevel, iface: Optional[Dict], device, dtype,
                  name: str = "iface", slab: Optional[Tuple[int, int]] = None
                  ) -> List[Optional[torch.Tensor]]:
    """The ghost plane of each face (None where the face is no interface),
    checked against the level: pre-shifted (27, A, B) in the storage type
    `dtype` (float32 f, or bf16 g = f - w), contiguous.  A scheduler's
    sub-step n of an (nw, 27, A, B) pair tensor is `plane[n]`, a
    contiguous view (`dense_step.interface_planes_pair_mm`).  For the x
    slab `slab` = (x_off, XL) of the level, the y and z faces' planes are
    the slab's (27, XL, B), and an x face's plane is needed (and given to
    the kernel) only by the slab that holds it."""
    iface = iface or {}
    dims = list(patch.interior)
    held = (True, True)
    if slab is not None:
        x_off, dims[0] = slab
        held = (x_off == 0, x_off + dims[0] == patch.interior[0])
    planes = []
    for face in range(6):
        if patch.face_bc[face] != BC_INTERFACE or (face < 2 and not held[face]):
            planes.append(None)
            continue
        if face not in iface:
            raise ValueError(f"interface face {face} has no ghost plane in {name}")
        t = [a for a in range(3) if a != face // 2]
        shape = (27, dims[t[0]], dims[t[1]])
        _check(iface[face], f"{name}[{face}]", shape, (dtype,), device)
        planes.append(iface[face])
    return planes


def _check_plan(plan: Dict, level_shape, device, coefs=(("S", (torch.float32,)),)
                ) -> None:
    for key, dtypes in coefs:
        _check(plan[key], key, (27,) + tuple(plan["dim"]), dtypes, device)
    lx, ly, lz = plan["lo"]
    bx, by, bz = plan["dim"]
    X, Y, Z = level_shape
    if lx < 0 or ly < 0 or lz < 0 or lx + bx > X or ly + by > Y or lz + bz > Z:
        raise ValueError(f"Bouzidi box {plan['lo']}+{plan['dim']} outside {X, Y, Z}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def stream_collide(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w
    vel: torch.Tensor,  # (3, X, Y, Z) float32
    u_inlet: float,
    t_seed: int,
    static: Dict,  # obstacle (bool), sponge, wall_dist: (X, Y, Z)
    patch: PatchLevel,
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    iface: Optional[Dict[int, torch.Tensor]] = None,  # face -> (27, A, B), f's dtype
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    x_off: int = 0,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """K1: one stream-collide sub-step.  Returns new (f, rho, vel) in the
    storage dtype of `f` (A -> B buffers; the inputs are not modified),
    written into `out=(f_out, rho, vel_out)` where given (`_check_out`).
    `u_inlet` and `t_seed`: numbers, or a step record entry and None.
    `iface` holds the pre-shifted ghost plane of each interface face in
    f's storage type (`_iface_planes`).  With `edges` = (f_edges (27, 2, Y,
    Z) in f's dtype, v_edges (3, 2, Y, Z) float32), f, vel and the statics
    are the x slab of f's planes from the level's global plane `x_off`
    (K1's sharded form, `dense_step.dense_stream_collide`)."""
    X, Y, Z = patch.interior
    dev = f.device
    _check_level(f, vel, static, patch, edges, x_off)
    XL = f.shape[1]
    planes = _iface_planes(patch, iface, dev, f.dtype,
                           slab=None if edges is None else (x_off, XL))
    if out is not None:
        _check_out(out, f, vel, XL, Y, Z, dev, "stream_collide")
    kw = dict(
        c_wale=c_wale, nu_sgs_background=nu_sgs_background,
        inlet_turbulence=inlet_turbulence, wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    if dev.type == "cpu":
        fo, rho, vo = dense_stream_collide(
            storage.decode_f(f), vel, *_host_step(u_inlet, t_seed), static, patch,
            iface=iface, edges=_decoded(edges), x_off=x_off, **kw,
        )
        if f.dtype == torch.bfloat16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return _put(out, (fo, rho, vo))
    if dev.type != "cuda":
        raise ValueError(f"stream_collide: unsupported device {dev}")

    f_out, rho, vel_out = out if out is not None else (
        torch.empty_like(f), torch.empty((XL, Y, Z), dtype=torch.float32, device=dev),
        torch.empty_like(vel))
    head = [int(f.dtype == torch.bfloat16),
            f.data_ptr(), vel.data_ptr(), f_out.data_ptr(), rho.data_ptr(),
            vel_out.data_ptr(),
            static["obstacle"].data_ptr(), static["sponge"].data_ptr(),
            static["wall_dist"].data_ptr(),
            *[_ptr(p) for p in planes]]
    tail = [XL, Y, Z, int(patch.lo[1]), int(patch.lo[2]),
            *[int(b) for b in patch.face_bc],
            *_step_args(u_inlet, t_seed, dev),
            float(patch.tau), float(c_wale), float(nu_sgs_background),
            float(inlet_turbulence),
            int(bool(wall_model)), int(bool(sponge_blend))]
    with _on_card(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if edges is None:
            fn = _lib("stream_collide", "ol_stream_collide", _SC_ARGTYPES)
            rc = fn(*head, *tail, stream)
            name = "stream_collide"
        else:
            fn = _lib("stream_collide", "ol_stream_collide_shard",
                      _SC_SHARD_ARGTYPES)
            rc = fn(*head, edges[0].data_ptr(), edges[1].data_ptr(), int(x_off), X,
                    *tail, stream)
            name = "stream_collide_shard"
    _raise_on(rc, name)
    _count(name)
    return f_out, rho, vel_out


def _decoded(edges):
    """Edge planes with f_edges decoded to float32 f-space (the plain
    steps' input), or None."""
    return None if edges is None else (storage.decode_f(edges[0]), edges[1])


_LINK_DTYPES = {"cell": torch.int32, "code": torch.uint8, "src": torch.int32,
                "a": torch.float32, "j": torch.uint8, "far": torch.int32,
                "scratch": torch.float32}


def _check_links(plan: Dict, level_shape, device, keys, coef_dtype=None) -> Dict:
    """The plan's link list on `device` (`dense_step.bouzidi_plan_to`,
    `bouzidi_ab_plan`), its arrays `keys` checked against the level (A and
    B in `coef_dtype`); returns it."""
    if tuple(plan["level"]) != tuple(level_shape):
        raise ValueError(f"Bouzidi plan of a level {tuple(plan['level'])}, f's "
                         f"level is {tuple(level_shape)}")
    links = plan["links"]
    n = links["cell"].shape[0]
    for key in keys:
        dtype = coef_dtype if key in ("A", "B") else _LINK_DTYPES[key]
        _check(links[key], f"links[{key!r}]", (n,), (dtype,), device)
    if n == 0:
        raise ValueError("a Bouzidi plan without links (the plan is None then)")
    return links


def bouzidi(f: torch.Tensor, plan: Dict, halo: Optional[torch.Tensor] = None,
            inplace: bool = False) -> torch.Tensor:
    """K2: Bouzidi correction of (27, X, Y, Z) f (float32 f or bf16 g) over
    the plan's link list.  On CUDA the links (and their scratch) are
    tensors on f's device (`dense_step.bouzidi_plan_to`), the correction is
    written into `f` in place by one launch and `f` is returned; on the CPU
    the plain version returns a new tensor, or with `inplace` its result is
    copied into `f` (the graphed runner's fixed buffers). With `halo` (1-D,
    f's dtype, on f's device) f is one x slab of a level and the plan its
    links (`parallel.patch_shard.shard_statics`): a link with src = -1 - h
    reads halo[h], gathered from another slab before any slab's correction
    (K2's sharded form)."""
    dev = f.device
    if f.dim() != 4 or f.shape[0] != 27:
        raise ValueError(f"f shape {tuple(f.shape)}, expected (27, X, Y, Z)")
    _check(f, "f", f.shape, (torch.float32, torch.bfloat16), dev)
    if halo is not None:
        _check(halo, "halo", (halo.numel(),), (f.dtype,), dev)
    X, Y, Z = f.shape[1:]
    if dev.type == "cpu":
        out = apply_bouzidi_links(f, plan, halo)
        return f.copy_(out) if inplace else out
    if dev.type != "cuda":
        raise ValueError(f"bouzidi: unsupported device {dev}")
    links = _check_links(plan, (X, Y, Z), dev, ("cell", "code", "src", "a", "scratch"))
    ptrs = [links[key].data_ptr() for key in ("cell", "code", "src", "a", "scratch")]
    with _on_card(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if halo is None:
            fn = _lib("bouzidi", "ol_bouzidi", _BZ_ARGTYPES)
            rc = fn(int(f.dtype == torch.bfloat16), f.data_ptr(), *ptrs,
                    links["a"].shape[0], X, Y, Z, stream)
            name = "bouzidi"
        else:
            fn = _lib("bouzidi", "ol_bouzidi_shard", _BZ_SHARD_ARGTYPES)
            rc = fn(int(f.dtype == torch.bfloat16), f.data_ptr(), *ptrs,
                    halo.data_ptr(), links["a"].shape[0], X, Y, Z, stream)
            name = "bouzidi_shard"
    _raise_on(rc, name)
    _count(name)
    return f


def bouzidi_ab(f: torch.Tensor, plan: Dict) -> torch.Tensor:
    """K6: Bouzidi correction of (27, X, Y, Z) f (float32 f or bf16 g) with
    the two-array coefficients over the plan's link list
    (`dense_step.bouzidi_ab_plan`: A and B boxes and per link in f's dtype,
    on f's device).  On CUDA the correction is written into `f` in place by
    one launch and `f` is returned; on the CPU the plain version returns a
    new tensor."""
    dev = f.device
    if f.dim() != 4 or f.shape[0] != 27:
        raise ValueError(f"f shape {tuple(f.shape)}, expected (27, X, Y, Z)")
    _check(f, "f", f.shape, (torch.float32, torch.bfloat16), dev)
    _check_plan(plan, f.shape[1:], dev, (("A", (f.dtype,)), ("B", (f.dtype,))))
    X, Y, Z = f.shape[1:]
    keys = ("cell", "j", "far", "A", "B", "scratch")
    links = _check_links(plan, (X, Y, Z), dev, keys, f.dtype)
    if dev.type == "cpu":
        return apply_bouzidi_ab_links(f, plan)
    if dev.type != "cuda":
        raise ValueError(f"bouzidi_ab: unsupported device {dev}")
    fn = _lib("bouzidi_ab", "ol_bouzidi_ab_links", _BZAB_ARGTYPES)
    rc = fn(
        int(f.dtype == torch.bfloat16), f.data_ptr(),
        *[links[key].data_ptr() for key in keys],
        links["cell"].shape[0], X, Y, Z, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "bouzidi_ab")
    _count("bouzidi_ab")
    return f


def fused_pair(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w
    vel: torch.Tensor,  # (3, X, Y, Z) float32
    u: Tuple[float, float],  # (u_a, u_b) inlet velocity of steps A and B
    seed: Tuple[int, int],  # (seed_a, seed_b) inlet-noise seeds
    static: Dict,  # obstacle (bool), sponge, wall_dist: (X, Y, Z)
    patch: PatchLevel,
    plan: Optional[Dict],  # Bouzidi plan of the level (S on f's device), or None
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    iface_a: Optional[Dict[int, torch.Tensor]] = None,  # step A's ghost planes
    iface_b: Optional[Dict[int, torch.Tensor]] = None,  # step B's ghost planes
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """K3: two sub-steps of a childless level with step A's Bouzidi
    correction between them.  Returns step B's new (f, rho, vel) in the
    storage dtype of `f`, B's f uncorrected (A -> B buffers; the inputs are
    not modified), written into `out` where given (`_check_out`).  `u` and
    `seed`: numbers, or two step record entries and (None, None).
    `iface_a` / `iface_b` hold each sub-step's pre-shifted ghost planes in
    f's storage type (`_iface_planes`)."""
    X, Y, Z = patch.interior
    dev = f.device
    _check_level(f, vel, static, patch)
    planes_a = _iface_planes(patch, iface_a, dev, f.dtype, "iface_a")
    planes_b = _iface_planes(patch, iface_b, dev, f.dtype, "iface_b")
    if plan is not None:
        _check_plan(plan, (X, Y, Z), dev)
    if out is not None:
        _check_out(out, f, vel, X, Y, Z, dev, "fused_pair")
    (u_a, u_b), (seed_a, seed_b) = u, seed
    kw = dict(
        c_wale=c_wale, nu_sgs_background=nu_sgs_background,
        inlet_turbulence=inlet_turbulence, wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    if dev.type == "cpu":
        (u_a, seed_a), (u_b, seed_b) = (_host_step(u_a, seed_a),
                                        _host_step(u_b, seed_b))
        return _put(out, fused_pair_plain(
            f, vel, (u_a, u_b), (seed_a, seed_b), static, patch, plan,
            iface_a=iface_a, iface_b=iface_b, **kw))
    if dev.type != "cuda":
        raise ValueError(f"fused_pair: unsupported device {dev}")

    fn = _lib("fused_pair", "ol_fused_pair", _FP_ARGTYPES)
    f_out, rho, vel_out = out if out is not None else (
        torch.empty_like(f), torch.empty((X, Y, Z), dtype=torch.float32, device=dev),
        torch.empty_like(vel))
    sa, sb = _step_args(u_a, seed_a, dev), _step_args(u_b, seed_b, dev)
    if _is_ref(u_a) != _is_ref(u_b) or (_is_ref(u_a) and u_a.record is not u_b.record):
        raise ValueError("fused_pair: steps A and B read one step record, or none")
    box = (tuple(plan["lo"]) + tuple(plan["dim"])) if plan is not None \
        else (0,) * 6
    rc = fn(
        int(f.dtype == torch.bfloat16),
        f.data_ptr(), vel.data_ptr(), f_out.data_ptr(), rho.data_ptr(),
        vel_out.data_ptr(),
        static["obstacle"].data_ptr(), static["sponge"].data_ptr(),
        static["wall_dist"].data_ptr(),
        *[_ptr(p) for p in planes_a], *[_ptr(p) for p in planes_b],
        _ptr(plan["S"]) if plan is not None else None,
        X, Y, Z, int(patch.lo[1]), int(patch.lo[2]),
        *[int(b) for b in patch.face_bc],
        sa[0], sb[0], sa[1], sb[1], sa[2], sa[3], sa[4], *sa[5:], *sb[5:],
        float(patch.tau), float(c_wale), float(nu_sgs_background),
        float(inlet_turbulence),
        int(bool(wall_model)), int(bool(sponge_blend)),
        *[int(v) for v in box],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "fused_pair")
    _count("fused_pair")
    return f_out, rho, vel_out


def fused_pair_attrs(store_bf16: bool) -> Dict[str, int]:
    """K3's registers and local memory per thread, dynamic shared memory
    per block and resident blocks per SM on the current card."""
    fn = _lib("fused_pair", "ol_fused_pair_attrs",
              [_I] + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = fn(int(store_bf16), *[ctypes.byref(v) for v in vals])
    _raise_on(rc, "fused_pair attribute query")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _check_interface_free(patch: PatchLevel, what: str) -> None:
    if BC_INTERFACE in patch.face_bc:
        raise ValueError(f"{what} needs a level without interface faces, got "
                         f"face_bc {tuple(patch.face_bc)}")


def _step_scalars(patch: PatchLevel, u_inlet, t_seed, c_wale, nu_sgs_background,
                  inlet_turbulence, wall_model, sponge_blend, device, XL=None
                  ) -> list:
    """The (X, Y, Z, lo_y, lo_z, bc0..5, u, seed, the step record
    (`_step_args`), tau, c_wale, nu_sgs, inlet_turb, wall_model,
    sponge_blend) arguments of K4 and K5 launched on `device`, X the slab's
    `XL` where given."""
    X, Y, Z = patch.interior
    return [
        X if XL is None else XL, Y, Z, int(patch.lo[1]), int(patch.lo[2]),
        *[int(b) for b in patch.face_bc],
        *_step_args(u_inlet, t_seed, device),
        float(patch.tau), float(c_wale), float(nu_sgs_background),
        float(inlet_turbulence), int(bool(wall_model)), int(bool(sponge_blend)),
    ]


def stream_collide_flat(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w
    vel: torch.Tensor,  # (3, X, Y, Z) float32
    u_inlet: float,
    t_seed: int,
    static: Dict,  # obstacle (bool), sponge, wall_dist: (X, Y, Z)
    patch: PatchLevel,  # no interface faces
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    x_off: int = 0,
):
    """K4: one sub-step of an interface-free level.  Returns new (f, rho,
    vel) in the storage dtype of `f` (A -> B buffers; the inputs are not
    modified).  `out=(f_out, rho, vel_out)` are preallocated outputs (f's
    shape and dtype, (X, Y, Z) and (3, X, Y, Z) float32, on f's device),
    written and returned; without it the outputs are allocated.  `edges`
    and `x_off`: the sharded form, as in `stream_collide`; the launch shape
    is chosen for the slab's cells."""
    X, Y, Z = patch.interior
    dev = f.device
    _check_interface_free(patch, "stream_collide_flat")
    _check_level(f, vel, static, patch, edges, x_off)
    XL = f.shape[1]
    if out is not None:
        _check_out(out, f, vel, XL, Y, Z, dev, "stream_collide_flat")
    kw = dict(
        c_wale=c_wale, nu_sgs_background=nu_sgs_background,
        inlet_turbulence=inlet_turbulence, wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    if dev.type == "cpu":
        fo, rho, vo = stream_collide_flat_plain(
            storage.decode_f(f), vel, *_host_step(u_inlet, t_seed), static, patch,
            edges=_decoded(edges), x_off=x_off, **kw)
        if f.dtype == torch.bfloat16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return _put(out, (fo, rho, vo))
    if dev.type != "cuda":
        raise ValueError(f"stream_collide_flat: unsupported device {dev}")

    if out is None:
        out = (torch.empty_like(f), torch.empty((XL, Y, Z), dtype=torch.float32,
                                                device=dev),
               torch.empty_like(vel))
    head = [int(f.dtype == torch.bfloat16),
            f.data_ptr(), vel.data_ptr(), *[t.data_ptr() for t in out],
            static["obstacle"].data_ptr(), static["sponge"].data_ptr(),
            static["wall_dist"].data_ptr()]
    scalars = _step_scalars(patch, u_inlet, t_seed, **kw, device=dev, XL=XL)
    with _on_card(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if edges is None:
            fn = _lib("stream_collide_flat", "ol_stream_collide_flat", _FLAT_ARGTYPES)
            rc = fn(*head, *scalars, stream)
            name = "stream_collide_flat"
        else:
            fn = _lib("stream_collide_flat", "ol_stream_collide_flat_shard",
                      _FLAT_SHARD_ARGTYPES)
            rc = fn(*head, edges[0].data_ptr(), edges[1].data_ptr(), int(x_off), X,
                    *scalars, stream)
            name = "stream_collide_flat_shard"
    _raise_on(rc, name)
    _count(name)
    return tuple(out)


def flat_instantiation(n_cells: int, store_bf16: bool, resident: int
                       ) -> Dict[str, int]:
    """K4's instantiation for a level of `n_cells` (the rule of `choose` in
    csrc/stream_collide_flat.cu): "threads" per block and "min_blocks" per
    SM of its launch bounds.  128 threads at 64 registers (8 a SM) but for
    bf16 levels of more than two waves of `resident` (the blocks of that
    bf16 instantiation the card holds), which take 10 a SM (PERF.md)."""
    if store_bf16 and -(-n_cells // 128) > 2 * resident:
        return {"threads": 128, "min_blocks": 10}
    return {"threads": 128, "min_blocks": 8}


def flat_choice(patch: PatchLevel, store_bf16: bool) -> Dict[str, int]:
    """The instantiation K4 launches on `patch` on the current card, as
    its C entry chooses it, with "resident": the blocks of the 64-register
    bf16 instantiation the card holds at once."""
    fn = _lib("stream_collide_flat", "ol_stream_collide_flat_choice",
              [_I, _I, _I, _I] + [ctypes.POINTER(ctypes.c_int)] * 3)
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = fn(int(store_bf16), *patch.interior, *[ctypes.byref(v) for v in vals])
    _raise_on(rc, "stream_collide_flat instantiation query")
    return dict(zip(("threads", "min_blocks", "resident"), (v.value for v in vals)))


def inplace_layout(X: int, Y: int, Z: int, device, elem_bytes: int
                   ) -> Dict[str, int]:
    """K5's region layout (`ops/inplace_layout.py`) of an (X, Y, Z) level of
    `elem_bytes`-wide storage on the card of `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return inplace_layout_mod.inplace_layout(X, Y, Z, sms, elem_bytes)


def _inplace_launch(f, vel, rho, vel_out, edge, static, patch, lay, scalars,
                    parts: int, edges=None, x_off: int = 0) -> None:
    """Launch K5's edge copy (parts & 1) and its in-place step (parts & 2)
    on f's card, its sharded form with `edges`; raises if a launch
    fails."""
    head = [int(f.dtype == torch.bfloat16),
            f.data_ptr(), vel.data_ptr(), rho.data_ptr(), vel_out.data_ptr(),
            edge.data_ptr()]
    fields = [static["obstacle"].data_ptr(), static["sponge"].data_ptr(),
              static["wall_dist"].data_ptr()]
    with _on_card(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        if edges is None:
            fn = _lib("stream_collide_inplace", "ol_stream_collide_inplace",
                      _IP_ARGTYPES)
            rc = fn(*head, *fields, *scalars, lay["ty"], lay["xr"], parts, stream)
        else:
            fn = _lib("stream_collide_inplace", "ol_stream_collide_inplace_shard",
                      _IP_SHARD_ARGTYPES)
            rc = fn(*head, edges[0].data_ptr(), edges[1].data_ptr(), int(x_off),
                    int(patch.interior[0]), *fields, *scalars, lay["ty"],
                    lay["xr"], parts, stream)
    _raise_on(rc, "stream_collide_inplace")


def stream_collide_inplace(
    f: torch.Tensor,  # (27, X, Y, Z) float32 f or bf16 g = f - w; updated
    vel: torch.Tensor,  # (3, X, Y, Z) float32
    u_inlet: float,
    t_seed: int,
    static: Dict,  # obstacle (bool), sponge, wall_dist: (X, Y, Z)
    patch: PatchLevel,  # no interface faces
    *,
    c_wale: float,
    nu_sgs_background: float,
    inlet_turbulence: float,
    wall_model: bool,
    sponge_blend: bool,
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    x_off: int = 0,
    out: Optional[Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]] = None,
):
    """K5: one sub-step of an interface-free level written into `f` itself.
    Returns (f, rho, vel): `f` updated in place, rho and vel fresh (the
    input vel is not modified), or written into `out=(None or f, rho,
    vel_out)`.  `edges` and `x_off`: the sharded form, as
    in `stream_collide`, with the layout the slab's own; every slab's
    edges must be copied before any slab's launch, which overwrites the
    planes its neighbours read."""
    X, Y, Z = patch.interior
    dev = f.device
    _check_interface_free(patch, "stream_collide_inplace")
    _check_level(f, vel, static, patch, edges, x_off)
    XL = f.shape[1]
    if out is not None:
        _check_out(out, f, vel, XL, Y, Z, dev, "stream_collide_inplace",
                   f_in_place=True)
    kw = dict(
        c_wale=c_wale, nu_sgs_background=nu_sgs_background,
        inlet_turbulence=inlet_turbulence, wall_model=wall_model,
        sponge_blend=sponge_blend,
    )
    if dev.type == "cpu":
        return _put(None if out is None else (None,) + tuple(out[1:]),
                    stream_collide_inplace_plain(
                        f, vel, *_host_step(u_inlet, t_seed), static, patch,
                        edges=edges, x_off=x_off, **kw))
    if dev.type != "cuda":
        raise ValueError(f"stream_collide_inplace: unsupported device {dev}")

    lay = inplace_layout(XL, Y, Z, dev, f.element_size())
    # the edge buffer lives for the launch (a captured step's in the graph's pool)
    edge = torch.empty((max(lay["edge_elems"], 1),), dtype=f.dtype, device=dev)
    _, rho, vel_out = out if out is not None else (
        None, torch.empty((XL, Y, Z), dtype=torch.float32, device=dev),
        torch.empty_like(vel))
    _inplace_launch(f, vel, rho, vel_out, edge, static, patch, lay,
                    _step_scalars(patch, u_inlet, t_seed, **kw, device=dev, XL=XL),
                    parts=3, edges=edges, x_off=x_off)
    name = "stream_collide_inplace" if edges is None else "stream_collide_inplace_shard"
    _count(name)
    return f, rho, vel_out


def inplace_parts_ms(f, vel, u_inlet, t_seed, static, patch, reps: int, **kw
                     ) -> Dict[str, float]:
    """Milliseconds per launch of K5's edge copy and of its in-place step,
    each timed alone between CUDA events over `reps` launches.  A
    measurement, not a step: it counts no launch, and the step launched
    alone reads the edges of the last copy, so what it leaves in `f` is no
    solution."""
    X, Y, Z = patch.interior
    dev = f.device
    _check_interface_free(patch, "stream_collide_inplace")
    _check_level(f, vel, static, patch)
    lay = inplace_layout(X, Y, Z, dev, f.element_size())
    edge = torch.empty((max(lay["edge_elems"], 1),), dtype=f.dtype, device=dev)
    rho = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    vel_out = torch.empty_like(vel)
    scalars = _step_scalars(patch, u_inlet, t_seed, **kw, device=dev)
    out = {}
    for name, parts in (("edge_copy_ms", 1), ("step_ms", 2)):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        _inplace_launch(f, vel, rho, vel_out, edge, static, patch, lay,
                        scalars, parts)
        start.record()
        for _ in range(reps):
            _inplace_launch(f, vel, rho, vel_out, edge, static, patch, lay,
                            scalars, parts)
        end.record()
        torch.cuda.synchronize(dev)
        out[name] = start.elapsed_time(end) / reps
    return out


def inplace_attrs(store_bf16: bool, lay: Dict[str, int]) -> Dict[str, int]:
    """K5's registers and local memory per thread, dynamic shared memory
    per block and resident blocks per SM on the current card, for the run
    length of layout `lay`."""
    fn = _lib("stream_collide_inplace", "ol_stream_collide_inplace_attrs",
              [_I, _I] + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = fn(int(store_bf16), lay["xr"], *[ctypes.byref(v) for v in vals])
    _raise_on(rc, "stream_collide_inplace attribute query")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))

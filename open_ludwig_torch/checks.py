"""Kernel-against-plain checks and timings on the card.

Shared by `chip_smoke.py` and the CUDA-only tests: random inputs made from
a numpy seed go through a CUDA kernel and through its plain PyTorch
version on the same device; the result is the max-abs deviation and both
times from CUDA events.  Tolerances are the JAX package's own for the
same layers (`tests/test_patch_pallas.py:114, :400, :439`):

  K1 stream-collide: float32 < 1e-5; bf16 g-storage < 2e-3 (decoded f)
  K2 Bouzidi:        float32 < 1e-6; bf16 g-storage < 2e-3 (decoded f)
  K6 two-array Bouzidi: the same as K2, against its plain version
                     (float32 < 1e-6, bf16 < 2e-3); against K2 on the same
                     S (A and B in the storage dtype) the same, the probe's
                     bound in bf16
  K4 flat step, K5 in-place step: float32 < 1e-5; bf16 g-storage < 2e-3
                     (decoded f), against their plain versions (the
                     reference's flat and 2-D kernels are held to the XLA
                     path at these bounds, tests/test_patch_pallas.py:157);
                     against K1, which runs the same per-cell code, the
                     share of stored f entries that differ is reported
                     (expected 0)
  ghost planes (interface_planes_pair_mm, no kernel of its own): against
                     the endpoint path + shift_planes on the same parent
                     states, float32 planes < 2e-6 (tests/test_dense.py:222's
                     bound for the reference's pair); the storage-type planes
                     against the endpoint path's cast the same way, within
                     the bf16 bound 2e-3
  ghost-plane kernels (`ops.ghost_planes`): against the plain versions from
                     the same parent states, the endpoint slabs bit for bit,
                     float32 planes < 2e-6, bf16 planes at most one bf16 ulp
                     beyond the float32 planes' distance (`check_ghost_kernels`)
  K3 fused pair (+ K2 after it): against the plain pair, float32 < 1e-5,
                     bf16 g-storage < 2e-3 (decoded f); against the unfused
                     kernels K1 -> K2 -> K1 (+ K2), the same and, in bf16,
                     under 1% of the stored f entries differing: the
                     reference's fused-vs-sequential bound
                     (tests/test_fused2.py:119-125), which holds where both
                     sides run the same per-cell code.  Against the plain
                     pair, whose float32 op order differs, ~1.2% of stored
                     bf16 entries land one rounding apart after a pair
                     (tests/test_torch_fused_pair.py); that share is reported.

Each check also returns the call's bound: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, or its float32 operations over the card's float32 rate, whichever
is larger (`bound`), from the card's published peaks (`CARD_PEAKS`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from . import lattice as lat
from .cases import make_case_sphere
from .config import CaseConfig, load_case_config
from .core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
    build_patches,
)
from .geometry import load_mesh
from .scaling import DomainParams, compute_domain_params
from .ops import build, storage
from .ops.cuda_step import (
    bouzidi,
    bouzidi_ab,
    fused_pair,
    fused_pair_attrs,
    inplace_attrs,
    inplace_layout,
    inplace_parts_ms,
    stream_collide,
    stream_collide_flat,
    stream_collide_inplace,
)
from .ops.dense_step import (
    apply_bouzidi_ab_links,
    apply_bouzidi_dense,
    apply_bouzidi_links,
    bouzidi_ab_plan,
    dense_stream_collide,
    extract_endpoint_slabs,
    fused_pair_plain,
    iface_mm_matrices,
    interface_endpoints_pair,
    interface_from_endpoints,
    interface_planes_pair_mm,
    shift_planes,
    stream_collide_flat_plain,
    stream_collide_inplace_plain,
)

K1_TOL = {False: 1e-5, True: 2e-3}  # keyed by store_bf16
PLANE_TOL = 2e-6  # float32 planes; the storage-type planes take K1_TOL
K2_TOL = {False: 1e-6, True: 2e-3}
K3_TOL = {False: 1e-5, True: 2e-3}
K3_MAX_DIFF_FRAC = 0.01  # bf16: share of stored f entries that may differ

# Published peaks by `torch.cuda.get_device_name` (NVIDIA's H100 SXM data
# sheet: HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s,
# both at the 700 W power limit).
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                        "f32_ops_per_s": 67e12}}
# float32 operations of one fluid cell's sub-step in csrc/lbm_cell.cuh,
# counted from the source without the wall model's branch: moments ~131,
# sponge ~21, velocity gradient 18, WALE ~106, regularized BGK + Guo ~47,
# reconstruction ~108, rounded up.  Against ~145 B per cell in bf16 that is
# ~3 operations per byte, under the card's float32 ridge of 20.
CELL_OPS = 450
LINK_OPS = 3  # a * f_k + b * other, per linked Bouzidi slot


def nvidia_smi() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them: written beside every
    time, since a card below its 700 W limit runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def bound(nbytes: int, ops: int, device) -> Dict:
    """The least time the card could take for a call that moves `nbytes`
    and does `ops` float32 operations, and which of the two sets it."""
    name = torch.cuda.get_device_name(device)
    if name not in CARD_PEAKS:
        raise ValueError(f"no published peaks recorded for {name!r} (CARD_PEAKS)")
    peak = CARD_PEAKS[name]
    t_bytes = nbytes / peak["bytes_per_s"] * 1e3
    t_ops = ops / peak["f32_ops_per_s"] * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def step_work(patch: PatchLevel, store_bf16: bool, wall_model: bool,
              sub_steps: int = 1) -> Tuple[int, int]:
    """(bytes, float32 operations) of `sub_steps` fused stream-collide
    sub-steps of `patch`: f, vel, obstacle, sponge and (with the wall
    model) the wall distance read once, f, rho and vel written once, and
    each sub-step's interface ghost planes, pre-shifted (27, A, B) in the
    storage type, read once."""
    fb = 2 if store_bf16 else 4
    per_cell = 27 * fb + 12 + 1 + 4 + (4 if wall_model else 0) + 27 * fb + 4 + 12
    planes = 0
    for fc in range(6):
        if patch.face_bc[fc] == BC_INTERFACE:
            a, b = (patch.interior[t] for t in range(3) if t != fc // 2)
            planes += 27 * a * b * fb
    return (patch.n_cells * per_cell + sub_steps * planes,
            sub_steps * CELL_OPS * patch.n_cells)


def box_work(plan: Dict, coef_bytes: int, store_bf16: bool, links: int
             ) -> Tuple[int, int]:
    """(bytes, float32 operations) of one Bouzidi correction of `plan`'s
    box as a box sweep reads it: the box of f and the coefficients read
    once, the `links` linked slots written once (the earlier bound of K2)."""
    fb = 2 if store_bf16 else 4
    nb = int(np.prod(plan["dim"]))
    return 27 * fb * nb + coef_bytes + links * fb, LINK_OPS * links


def link_work(plan: Dict, store_bf16: bool, coef_bytes: int = 4
              ) -> Tuple[int, int]:
    """(bytes, float32 operations) that one Bouzidi correction of `plan`
    needs, whatever computes it: per linked slot, its two inputs read and
    its value written in the storage type, and its coefficient(s) of
    `coef_bytes` read; the rest of the box is not touched."""
    fb = 2 if store_bf16 else 4
    n = len(plan["links"]["cell"])
    return n * (3 * fb + coef_bytes), LINK_OPS * n


def bench_config(case_dir: str, **over) -> CaseConfig:
    """The bench case of bench.py:67-104 (sphere at Re~1M, N=25, 3 levels +
    wake, wall model, Bouzidi on the finest level, bf16 g-storage) written
    to `case_dir` and loaded as its YAML says: level 1 runs K4 under
    `flat_coarse: auto`.  `over` overrides case options."""
    opts = dict(steps=400, ramp_steps=200, output_freq=100000, diag_freq=100,
                wake_enabled=True, precision="bfloat16")
    opts.update(over)
    make_case_sphere(case_dir, "1M", **opts)
    return load_case_config(case_dir)


CASES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "CASES")


def edit_config(case_dir: str, overrides: Dict[str, object]) -> None:
    """Set dotted keys of `case_dir`/config.yaml ("advanced.numerics.u_lattice"),
    making the sections a key names where they are missing."""
    path = os.path.join(case_dir, "config.yaml")
    with open(path) as fh:
        doc = yaml.safe_load(fh)
    for key, value in overrides.items():
        sec = doc
        *parents, leaf = key.split(".")
        for p in parents:
            sec = sec.setdefault(p, {})
        sec[leaf] = value
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)


def copy_case(name: str, case_dir: str, overrides: Dict[str, object]) -> str:
    """The shipped case CASES/`name` (config.yaml and its STL) copied to
    `case_dir`, its config edited by `edit_config`."""
    src = os.path.join(CASES_DIR, name)
    os.makedirs(case_dir, exist_ok=True)
    with open(os.path.join(src, "config.yaml")) as fh:
        stl = yaml.safe_load(fh)["basic"]["stl_file"]
    shutil.copy(os.path.join(src, stl), os.path.join(case_dir, stl))
    shutil.copy(os.path.join(src, "config.yaml"), os.path.join(case_dir, "config.yaml"))
    edit_config(case_dir, overrides)
    return case_dir


def shipped_config(case_dir: str, name: str, symmetric: bool = False) -> CaseConfig:
    """The shipped case CASES/`name` copied to `case_dir` and cut to 200
    coarse steps (the shipped configs run 6,000-12,000): forces and
    diagnostics every 50, no flow file; `symmetric` makes it the half
    model (`refinement.symmetric_analysis`, the mirror plane y = 0 through
    the body)."""
    steps = 200
    copy_case(name, case_dir, {
        "basic.simulation.steps": steps, "basic.simulation.output_freq": 10 * steps,
        "advanced.diagnostics.freq": 50,
        "advanced.refinement.symmetric_analysis": symmetric})
    return load_case_config(case_dir)


def case_levels(cfg: CaseConfig) -> Tuple[object, DomainParams, List[PatchLevel]]:
    """The case's mesh, domain parameters and the port's levels, built as
    solve_case builds them."""
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return mesh, params, build_patches(cfg, mesh, params)


def bench_case(case_dir: str, **over) -> Tuple[CaseConfig, object, DomainParams,
                                               List[PatchLevel]]:
    """bench_config, its mesh, domain parameters and the port's levels."""
    cfg = bench_config(case_dir, **over)
    return (cfg,) + case_levels(cfg)


def time_cuda(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Milliseconds per call over `reps` calls, between CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int, calls: int = 20) -> float:
    """Milliseconds per call of `fn` replayed from a CUDA graph of `calls`
    calls, between CUDA events over `reps` replays: the device's time with
    no host launch overhead between the calls.  What `fn` allocates comes
    from the graph's pool and must not outlive the call (an in-place
    kernel, preallocated outputs, or outputs dropped at once)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_cuda(graph.replay, reps) / calls


def random_level_inputs(patch: PatchLevel, store_bf16: bool, seed: int,
                        device) -> Dict:
    """f (storage dtype), vel and the ghost planes of both sub-steps of a
    pair for every interface face of `patch`, perturbed around rest; drawn
    on `device` from `seed` (a 63.7M-cell level takes no host round trip).
    "iface" maps face -> (2, 27, A, B), pre-shifted planes in the storage
    space (bf16 g = f - w, or float32 f) as `interface_planes_pair_mm`
    makes them; sub-step n reads plane[n] (`sub_step_planes`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sh = tuple(patch.interior)
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=device)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device)

    f = w.view(27, 1, 1, 1) * (1 + 0.05 * randn((27,) + sh))
    if store_bf16:
        f = storage.encode_f(f, storage.STORE_BF16)
    vel = 0.02 * randn((3,) + sh)
    planes = {}
    for fc in range(6):
        if patch.face_bc[fc] != BC_INTERFACE:
            continue
        t = [a for a in range(3) if a != fc // 2]
        pl = w.view(27, 1, 1) * (1 + 0.03 * randn((2, 27, sh[t[0]], sh[t[1]])))
        planes[fc] = (pl - w.view(27, 1, 1)).to(torch.bfloat16) if store_bf16 else pl
    return {"f": f, "vel": vel, "iface": planes}


def sub_step_planes(iface: Dict[int, torch.Tensor], n: int) -> Dict[int, torch.Tensor]:
    """Sub-step n's planes of a pair's (nw, 27, A, B) plane tensors."""
    return {fc: pl[n] for fc, pl in iface.items()}


def bench_k1_cases(levels: List[PatchLevel], statics: List[Dict]
                   ) -> List[Tuple[str, PatchLevel, Dict]]:
    """K1 check configurations on the bench levels: level 1 as built (inlet,
    outlet, mirrors), level 2's box with two face mixes that put the inlet
    and the outlet beside interface and mirror faces, and level 3 as built
    (six interface faces, the sphere's wall-model cells)."""
    mix_a = (BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE, BC_MIRROR_Z,
             BC_INTERFACE)
    mix_b = (BC_INTERFACE, BC_OUTLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE,
             BC_MIRROR_Z)
    return [
        ("L1", levels[0], statics[0]),
        ("L2-inlet-mix", dataclasses.replace(levels[1], face_bc=mix_a),
         with_sponge_ramp(statics[1])),
        ("L2-outlet-mix", dataclasses.replace(levels[1], face_bc=mix_b),
         with_sponge_ramp(statics[1])),
        ("L3", levels[2], with_sponge_ramp(statics[2])),
    ]


# K1's level shapes in the benchmark's cells (`lbm_bench/configs`), with the
# storage type each runs: the headline's L2 and L3 (bf16), Re10M's L2-L4
# and the 400^3 row (float32)
K1_SHAPES = (
    ("re1m_bench L2", (46, 48, 104), True),
    ("re1m_bench L3", (60, 64, 128), True),
    ("re10m L2", (48, 48, 120), False),
    ("re10m L3", (62, 64, 128), False),
    ("re10m L4", (94, 88, 128), False),
    ("64m_row", (400, 400, 400), False),
)
# face mixes of `k1_level`: a child level (every face an interface), the
# two mixes of `bench_k1_cases` and a wind tunnel (inlet, outlet, mirrors)
K1_FACES = {
    "iface": (BC_INTERFACE,) * 6,
    "inlet-mix": (BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE, BC_MIRROR_Z,
                  BC_INTERFACE),
    "outlet-mix": (BC_INTERFACE, BC_OUTLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE,
                   BC_MIRROR_Z),
    "tunnel": (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z,
               BC_MIRROR_Z),
}


def k1_level(shape, faces: str, device) -> Tuple[PatchLevel, Dict]:
    """A level of interior `shape` with the face mix `K1_FACES[faces]` and
    its statics made on `device`: a solid ball at the centre (radius a
    sixth of the smallest side), wall distances in (0, 4) on the three
    cells outside it (100 elsewhere, as domain/fields.py marks the far
    field), and a sponge ramp over the last three x planes."""
    patch = PatchLevel(2, 0.05, 0.54, (3, 5, 7), tuple(shape), K1_FACES[faces],
                       None, None, None)
    ax = [torch.arange(n, device=device, dtype=torch.float32) - (n - 1) / 2
          for n in shape]
    r = torch.sqrt(ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2
                   + ax[2][None, None, :] ** 2)
    rad = min(shape) / 6.0
    wall = torch.where((r >= rad) & (r < rad + 3), r - rad + 0.5,
                       torch.full_like(r, 100.0))
    static = {"obstacle": (r < rad).contiguous(),
              "sponge": torch.zeros(shape, device=device),
              "wall_dist": wall.contiguous()}
    del r, ax
    return patch, with_sponge_ramp(static)


def with_sponge_ramp(static: Dict) -> Dict:
    """The level's statics with a sponge ramp over its last three x-planes
    (so the sponge blend runs even on levels inside the sponge-free core)."""
    sponge = static["sponge"].clone()
    ramp = torch.linspace(0.1, 0.6, 3, device=sponge.device)[:, None, None]
    sponge[-3:] = torch.maximum(sponge[-3:], ramp)
    return {**static, "sponge": sponge}


def state_diff(fa: torch.Tensor, ra: torch.Tensor, va: torch.Tensor,
               fb: torch.Tensor, rb: torch.Tensor, vb: torch.Tensor) -> Dict:
    """Max-abs differences of f (decoded), rho and vel between two level
    states, and the share of stored f entries that differ."""
    err = {
        "f": float((storage.decode_f(fa) - storage.decode_f(fb)).abs().max()),
        "rho": float((ra - rb).abs().max()),
        "vel": float((va - vb).abs().max()),
    }
    return {"err": err, "max_abs_err": max(err.values()),
            "diff_frac": float((fa != fb).float().mean()),
            "finite": bool(torch.isfinite(storage.decode_f(fa)).all())}


def check_iface_planes(child: PatchLevel, parent: PatchLevel, plan: Dict,
                       store_bf16: bool, seed: int, device, reps: int = 20) -> Dict:
    """The plain ghost planes of `child` (the CPU's path, which
    `check_ghost_kernels` holds the card's kernels to; device plan `plan`,
    statics[l]["iface_mm"]) from two random parent states, old and new
    (`extract_endpoint_slabs` of each, `interface_planes_pair_mm` at the
    temporal weights 0.0 and 0.5, g-space on bf16 as the scheduler makes
    them), against the endpoint path (`interface_endpoints_pair` +
    `interface_from_endpoints`) + `shift_planes` on the card: "max_abs_err"
    of the planes computed in float32, "store_err" of the storage-type
    planes against the endpoint path's cast alike.  Then one child build
    as the scheduler runs it (the new state's slabs, then the planes from
    the carried old ones): "ms" per build eager (CUDA events over `reps`;
    the host's pace), its device operations and their device time per
    build ("device_ops", "device_ms"; torch.profiler), and the endpoint
    path's ms per build without the shift ("endpoint_ms": the build before
    the einsum plan)."""
    from .tools.profile_slice import profile_calls

    gen = torch.Generator(device=device).manual_seed(seed)
    sh = tuple(parent.interior)
    dt = torch.bfloat16 if store_bf16 else torch.float32
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=device).view(27, 1, 1, 1)

    def state():
        f = w * (1 + 0.05 * torch.randn((27,) + sh, generator=gen, device=device))
        return {"f": storage.encode_f(f, storage.STORE_BF16) if store_bf16 else f,
                "rho": 1 + 0.02 * torch.randn(sh, generator=gen, device=device),
                "vel": 0.03 * torch.randn((3,) + sh, generator=gen, device=device)}

    plan = iface_mm_matrices(plan)
    old, new = state(), state()
    sl_old = extract_endpoint_slabs(plan, old)

    def build(out_dtype=dt):
        return interface_planes_pair_mm(plan, child, parent, sl_old,
                                        extract_endpoint_slabs(plan, new), True,
                                        g_shifted=store_bf16, out_dtype=out_dtype)

    def endpoint():
        ep_old, ep_new = interface_endpoints_pair(child, parent, old, new)
        return [interface_from_endpoints(ep_new, ep_old, child, parent, tw, True)
                for tw in (0.0, 0.5)]

    got32, got = build(torch.float32), build()
    raw = endpoint()
    err = store_err = 0.0
    for n in (0, 1):
        want = shift_planes(raw[n], child, store_bf16, torch.float32)
        for fc, pl in want.items():
            err = max(err, float((got32[fc][n] - pl).abs().max()))
            store_err = max(store_err, float(
                (got[fc][n].float() - pl.to(dt).float()).abs().max()))
    torch.cuda.synchronize()
    prof = profile_calls(build, 5)
    return {"max_abs_err": err, "tol": PLANE_TOL, "store_err": store_err,
            "store_tol": K1_TOL[store_bf16],
            "faces": len(got), "groups": len(plan["groups"]),
            "device_ops": prof["device_ops"],
            "device_ms": prof["port_device_ms"] + prof["other_device_ms"],
            "ms": time_cuda(build, reps), "endpoint_ms": time_cuda(endpoint, reps)}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, a32: Optional[torch.Tensor] = None,
              b32: Optional[torch.Tensor] = None) -> float:
    """The largest distance of two bf16 tensors in units of the bf16 ulp at
    the larger of the two magnitudes (8 significant bits); with the float32
    values they round (`a32`, `b32`), the distance beyond theirs.  Rounding
    two float32 values to bf16 moves each by at most half an ulp, so two
    roundings add at most one ulp to the float32 values' own distance,
    which near zero spans several bf16 ulps by itself."""
    d = (a.float() - b.float()).abs()
    if a32 is not None:
        d = (d - (a32.float() - b32.float()).abs()).clamp(min=0.0)
    _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
    return float((d / torch.ldexp(torch.ones_like(d), e - 8)).max())


_IFACE6 = (BC_INTERFACE,) * 6
# Ghost-plane geometries beyond the shipped cases' (every one of which has
# six interface faces): (parent lo, child lo, child interior, child
# face_bc) on a (20, 16, 16) parent: inside the parent, offset (a level 3+
# parent), reaching past the parent's edges (the clamp), one face of the y
# group a mirror (a group of one face), and no interface face along z (two
# groups)
GHOST_GEOMS = {
    "lo0": ((0, 0, 0), (10, 8, 8), (14, 12, 12), _IFACE6),
    "lo642": ((6, 4, 2), (22, 16, 12), (14, 12, 12), _IFACE6),
    "edge": ((0, 0, 0), (2, 2, 2), (16, 14, 30), _IFACE6),
    "nf1": ((6, 4, 2), (22, 16, 12), (14, 12, 12),
            (BC_INTERFACE,) * 3 + (BC_MIRROR_Y,) + (BC_INTERFACE,) * 2),
    "no_z": ((0, 0, 0), (10, 8, 8), (14, 12, 12),
             (BC_INTERFACE,) * 4 + (BC_MIRROR_Z,) * 2),
}


def ghost_levels(name: str) -> Tuple[PatchLevel, PatchLevel]:
    """(parent, child) of `GHOST_GEOMS[name]`, without fields."""
    parent_lo, child_lo, child_in, face_bc = GHOST_GEOMS[name]
    parent = PatchLevel(1, 0.1, 0.58, parent_lo, (20, 16, 16), (BC_INLET,) * 6,
                        None, None, None)
    child = PatchLevel(2, 0.05, 0.54, child_lo, child_in, face_bc, None, None, None)
    return parent, child


def ghost_build_bytes(plan: Dict, store_bf16: bool, nw: int) -> Dict[str, int]:
    """Bytes each part of one child build must move (each input read once,
    each output written once): "extract", the two parent planes along
    each face's normal over its window (f in the storage type, rho and vel
    float32) read and the float32 slabs written; "planes", the slabs read
    (old and new with the temporal blend, nw = 2) and the planes written,
    (nw, 27, A, B) a face in the storage type; "carry", with the blend the
    graphed runner's copy of the new slabs into the old (read and
    written).  The two-kernel build's bound is "extract" + "planes": the
    carry is a cost of that schedule, not of the planes.  "fused", the
    one-launch build (`ops.ghost_planes.build`): the parent's two planes a
    face read once from each state it reads (old and new with the blend,
    the new alone without) and the planes written."""
    fb = 2 if store_bf16 else 4
    out = {"extract": 0, "planes": 0, "carry": 0, "fused": 0}
    for g in plan["groups"]:
        t0, t1 = [a for a in range(3) if a != g["axis"]]
        nf = len(g["faces"])
        slab = nf * 31 * g["sizes"][t0] * g["sizes"][t1] * 4
        window = 2 * nf * (27 * fb + 16) * g["sizes"][t0] * g["sizes"][t1]
        plane = nf * nw * 27 * g["A"] * g["B"] * fb
        out["extract"] += window + slab
        out["planes"] += nw * slab + plane
        out["carry"] += 2 * slab if nw == 2 else 0
        out["fused"] += nw * window + plane
    return out


def check_ghost_kernels(child: PatchLevel, parent: PatchLevel, plan: Dict,
                        store_bf16: bool, use_temporal: bool, seed: int, device,
                        reps: int = 20) -> Dict:
    """The ghost planes' kernels (`ops.ghost_planes`) against their plain
    versions on the card, from two random parent states (old, new) in the
    parent's storage type: the extraction bit for bit ("slabs_equal"); the
    float32 planes of both from the same slabs ("max_abs_err", `PLANE_TOL`),
    g planes with `store_bf16` as the scheduler makes them; with
    `store_bf16` the bf16 g planes: the kernel's its float32 planes rounded
    ("bf16_is_cast"), and against the plain ones at most one bf16 ulp
    beyond the float32 planes' distance ("max_ulps", `bf16_ulps`), with the
    distance alone in ulps ("raw_ulps") and the share of bf16 values that
    differ ("bf16_diff_frac"); None on float32.  The fused build
    (`ghost_planes.build`) from the same two states: its float32 planes and
    its planes in the storage type equal the two kernels' bit for bit
    ("fused_equal").  Then, replayed from CUDA graphs, each part of a child
    build as the scheduler runs it, with its bytes (`ghost_build_bytes`)
    and bound: "build" the two-kernel build, the new state's extraction and
    the planes from the carried old slabs (and "ms", "bytes", "bound_ms"
    and "plain_ms", the plain versions' same build, at the top level),
    "extract" and "planes" each kernel alone beside its plain version, with
    `use_temporal` "carry" the carry's one copy (None without), and
    "fused" the one-launch build from the two states."""
    from .ops import ghost_planes
    from .solver_dense import FixedBuffers

    gen = torch.Generator(device=device).manual_seed(seed)
    sh = tuple(parent.interior)
    dt = torch.bfloat16 if store_bf16 else torch.float32
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=device).view(27, 1, 1, 1)

    def state():
        f = w * (1 + 0.05 * torch.randn((27,) + sh, generator=gen, device=device))
        return {"f": storage.encode_f(f, storage.STORE_BF16) if store_bf16 else f,
                "rho": 1 + 0.02 * torch.randn(sh, generator=gen, device=device),
                "vel": 0.03 * torch.randn((3,) + sh, generator=gen, device=device)}

    old, new = state(), state()
    k_old, k_new = (ghost_planes.extract_slabs(plan, s) for s in (old, new))
    p_old, p_new = (extract_endpoint_slabs(plan, s) for s in (old, new))
    equal = all(torch.equal(a[key], b[key]) for ka, pa in ((k_old, p_old), (k_new, p_new))
                for a, b in zip(ka, pa) for key in ("f", "rho", "vel"))
    o_k, o_p = (k_old, p_old) if use_temporal else (None, None)

    def kernel(slabs_old, slabs_new, out_dtype):
        return ghost_planes.planes(plan, child, parent, slabs_old, slabs_new,
                                   use_temporal, store_bf16, out_dtype)

    plain_plan = iface_mm_matrices(plan)

    def plain(slabs_old, slabs_new, out_dtype):
        return interface_planes_pair_mm(plain_plan, child, parent, slabs_old, slabs_new,
                                        use_temporal, store_bf16, out_dtype)

    got32, want32 = kernel(o_k, k_new, torch.float32), plain(o_p, p_new, torch.float32)
    err = max(float((got32[fc] - pl).abs().max()) for fc, pl in want32.items())
    ulps = raw = frac = cast = None  # float32 planes: "max_abs_err" says it
    if store_bf16:
        got, want = kernel(o_k, k_new, dt), plain(o_p, p_new, dt)
        ulps = max(bf16_ulps(got[fc], want[fc], got32[fc], want32[fc]) for fc in want)
        raw = max(bf16_ulps(got[fc], want[fc]) for fc in want)
        frac = (sum(int((got[fc] != want[fc]).sum()) for fc in want)
                / sum(want[fc].numel() for fc in want))
        cast = all(torch.equal(got[fc], got32[fc].to(dt)) for fc in want)
    o_st = old if use_temporal else None

    def fused(out_dtype):
        return ghost_planes.build(plan, child, parent, o_st, new, use_temporal,
                                  store_bf16, out_dtype)

    fused_equal = all(torch.equal(a[fc], b[fc]) for a, b in (
        (fused(torch.float32), got32),
        (fused(dt), got32 if dt == torch.float32 else got)) for fc in want32)

    carried = ghost_planes.extract_slabs(plan, old)
    carried_p = extract_endpoint_slabs(plan, old)
    torch.cuda.synchronize()
    o_k = carried if use_temporal else None
    o_p = carried_p if use_temporal else None
    nw = 2 if use_temporal else 1
    nbytes = ghost_build_bytes(plan, store_bf16, nw)

    def part(fn, plain_fn, n):
        return {"ms": graph_ms(fn, reps),
                "plain_ms": None if plain_fn is None else graph_ms(plain_fn, reps),
                **bound(n, 0, device)}

    parts = {
        "build": part(lambda: kernel(o_k, ghost_planes.extract_slabs(plan, new), dt),
                      lambda: plain(o_p, extract_endpoint_slabs(plan, new), dt),
                      nbytes["extract"] + nbytes["planes"]),
        "extract": part(lambda: ghost_planes.extract_slabs(plan, new),
                        lambda: extract_endpoint_slabs(plan, new), nbytes["extract"]),
        "planes": part(lambda: kernel(o_k, k_new, dt), lambda: plain(o_p, p_new, dt),
                       nbytes["planes"]),
        "carry": (part(lambda: FixedBuffers.carry(carried, k_new), None, nbytes["carry"])
                  if use_temporal else None),
        "fused": part(lambda: fused(dt),
                      lambda: plain(extract_endpoint_slabs(plan, old) if use_temporal
                                    else None, extract_endpoint_slabs(plan, new), dt),
                      nbytes["fused"]),
    }
    return {"slabs_equal": equal, "max_abs_err": err, "tol": PLANE_TOL,
            "max_ulps": ulps, "raw_ulps": raw, "bf16_diff_frac": frac,
            "bf16_is_cast": cast, "fused_equal": fused_equal,
            "faces": len(want32), "groups": len(plan["groups"]),
            **parts["build"], **parts}


def check_stream_collide(patch: PatchLevel, static: Dict, store_bf16: bool,
                         seed: int, kw: Dict, device, reps: int = 20,
                         plain_reps: int = 3) -> Dict:
    """K1 against dense_stream_collide on the card.  Returns max-abs errors
    of f (decoded), rho and vel, and ms per call of both."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    u, s = 0.04, 9
    iface = sub_step_planes(inp["iface"], 0)

    def kernel():
        return stream_collide(inp["f"], inp["vel"], u, s, static, patch,
                              iface=iface, **kw)

    def plain():
        fo, ro, vo = dense_stream_collide(
            storage.decode_f(inp["f"]), inp["vel"], u, s, static, patch,
            iface=iface, **kw)
        if store_bf16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return fo, ro, vo

    fk, rk, vk = kernel()
    fp, rp, vp = plain()
    torch.cuda.synchronize()
    out = {**state_diff(fk, rk, vk, fp, rp, vp), "tol": K1_TOL[store_bf16],
           **bound(*step_work(patch, store_bf16, kw["wall_model"]), device)}
    del fk, rk, vk, fp, rp, vp
    out["ms"] = time_cuda(kernel, reps)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


def ptxas_summary(log: str) -> List[Dict]:
    """Registers and spills per kernel function from an `nvcc -Xptxas -v`
    log (`build.Built.ptxas_log`): [{"function", "registers",
    "spill_stores", "spill_loads"}] in the log's order."""
    out, fn, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.append({"function": fn, "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1]})
            fn, spills = None, (0, 0)
    return out


def substituted_call(ref: build.Built, name: str, fn: Callable[[], object]
                     ) -> Callable[[], object]:
    """`fn` with the wrappers launching `ref` (another build of kernel
    `name` with the same C interface, `build.load(name, csrc=DIR)`)."""
    def inner():
        with build.substituted(name, ref):
            return fn()
    return inner


def check_against(now: Tuple[Callable, Callable], ref: Tuple[Callable, Callable],
                  reps: int = 20, graph: bool = False) -> Dict:
    """A kernel against its earlier version on one input: each side is
    (run, call), `run()` giving the outputs compared (f first) and `call()`
    timed, in turns (today's, ref, ref, today's).  Returns "diff_frac" (the
    share of stored f entries that differ), "max_abs_err" (decoded f),
    "equal" (every output bit for bit), "turns_ms", "ms" and "ref_ms" (the
    better of each pair), and with `graph` the same replayed from a CUDA
    graph ("graph_turns_ms", "graph_ms", "ref_graph_ms")."""
    a, b = now[0](), ref[0]()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    torch.cuda.synchronize()
    out = {"diff_frac": float((a[0] != b[0]).float().mean()),
           "max_abs_err": float((storage.decode_f(a[0]) - storage.decode_f(b[0])).abs().max()),
           "equal": all(torch.equal(x, y) for x, y in zip(a, b))}
    del a, b
    turns = [time_cuda(fn, reps) for fn in (now[1], ref[1], ref[1], now[1])]
    out.update(turns_ms=turns, ms=min(turns[0], turns[3]), ref_ms=min(turns[1], turns[2]))
    if graph:
        turns = [graph_ms(fn, reps) for fn in (now[1], ref[1], ref[1], now[1])]
        out.update(graph_turns_ms=turns, graph_ms=min(turns[0], turns[3]),
                   ref_graph_ms=min(turns[1], turns[2]))
    return out


def check_step_against(ref: build.Built, name: str, patch: PatchLevel,
                       static: Dict, store_bf16: bool, seed: int, kw: Dict,
                       device, reps: int = 20) -> Dict:
    """A stream-collide kernel (`name`: "stream_collide" K1,
    "stream_collide_flat" K4, "stream_collide_inplace" K5, or "fused_pair"
    K3 with the level's Bouzidi plan) against `ref`, the same kernel built
    from another source (`check_against`), on one random input of `patch`;
    K1 and K4 also replayed from a CUDA graph into preallocated outputs.
    K5 writes its f in place: each compared run takes a fresh copy, the
    timed calls step one working copy."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    f, vel = inp["f"], inp["vel"]
    args = (0.04, 9, static, patch)
    graph = False
    if_a, if_b = (sub_step_planes(inp["iface"], n) for n in (0, 1))
    if name == "stream_collide":
        bufs = (torch.empty_like(f), torch.empty(f.shape[1:], device=device),
                torch.empty_like(vel))
        run = lambda: stream_collide(f, vel, *args, iface=if_a, **kw)
        call = lambda: stream_collide(f, vel, *args, iface=if_a, out=bufs, **kw)
        graph = True
    elif name == "stream_collide_flat":
        bufs = (torch.empty_like(f), torch.empty(f.shape[1:], device=device),
                torch.empty_like(vel))
        run = lambda: stream_collide_flat(f, vel, *args, **kw)
        call = lambda: stream_collide_flat(f, vel, *args, out=bufs, **kw)
        graph = True
    elif name == "stream_collide_inplace":
        work = f.clone()
        run = lambda: stream_collide_inplace(f.clone(), vel, *args, **kw)
        call = lambda: stream_collide_inplace(work, vel, *args, **kw)
    elif name == "fused_pair":
        run = call = lambda: fused_pair(
            f, vel, (0.04, 0.041), (9, 10), static, patch, static["bouzidi"],
            iface_a=if_a, iface_b=if_b, **kw)
    else:
        raise ValueError(f"check_step_against: no stream-collide kernel {name!r}")
    return check_against((run, call), (substituted_call(ref, name, run),
                                       substituted_call(ref, name, call)), reps, graph)


def _bouzidi_ab_box(ref: build.Built, f: torch.Tensor, pab: Dict) -> torch.Tensor:
    """K6 as built before its link list (C entry `ol_bouzidi_ab`: the box
    sweep after a snapshot of the box), in place on `f`: the earlier
    version `check_bouzidi_against` compares K6 with."""
    fn = ref.lib.ol_bouzidi_ab
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    (lx, ly, lz), (bx, by, bz) = pab["lo"], pab["dim"]
    snap = f[:, lx:lx + bx, ly:ly + by, lz:lz + bz].contiguous()
    rc = fn(int(f.dtype == torch.bfloat16), snap.data_ptr(), pab["A"].data_ptr(),
            pab["B"].data_ptr(), f.data_ptr(), bx, by, bz, lx, ly, lz,
            *f.shape[1:], torch.cuda.current_stream(f.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bouzidi_ab (reference) launch failed: CUDA error {rc}")
    return f


def check_bouzidi_against(ref: build.Built, name: str, patch: PatchLevel, plan: Dict,
                          store_bf16: bool, seed: int, device, reps: int = 50) -> Dict:
    """K2 (`name` "bouzidi") or K6 ("bouzidi_ab", A and B in f's dtype)
    against `ref`, the same kernel built from another source
    (`check_against`, eager and from a CUDA graph), on one random f of
    `patch`: each compared run from its own copy, the timed calls on one
    working copy.  A K6 `ref` without today's C entry is K6 before its link
    list, called as such (`_bouzidi_ab_box`)."""
    f0 = random_level_inputs(patch, store_bf16, seed, device)["f"]
    work = f0.clone()
    if name == "bouzidi":
        def apply(f):
            return bouzidi(f, plan)
    else:
        pab = bouzidi_ab_plan(plan, f0.dtype)

        def apply(f):
            return bouzidi_ab(f, pab)
    now = (lambda: apply(f0.clone()), lambda: apply(work))
    if name == "bouzidi_ab" and not hasattr(ref.lib, "ol_bouzidi_ab_links"):
        old = (lambda: _bouzidi_ab_box(ref, f0.clone(), pab),
               lambda: _bouzidi_ab_box(ref, work, pab))
    else:
        old = tuple(substituted_call(ref, name, fn) for fn in now)
    return check_against(now, old, reps, graph=True)


def check_flat(patch: PatchLevel, static: Dict, store_bf16: bool, seed: int,
               kw: Dict, device, reps: int = 20, plain_reps: int = 3) -> Dict:
    """K4 against stream_collide_flat_plain and against K1 on the card, from
    one input (A -> B: nothing is modified).  Returns max-abs errors against
    the plain version, the comparison with K1 ("k1": errors and the share
    of stored f entries that differ), and ms per call of K4 and K1 in turns
    (K4, K1, K1, K4: "turns_ms"; "ms" and "k1_ms" the better of each pair),
    the same replayed from a CUDA graph ("graph_turns_ms", "graph_ms",
    "k1_graph_ms"; K4 into preallocated outputs), and of the plain version."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    u, s = 0.04, 9
    f, vel = inp["f"], inp["vel"]
    bufs = (torch.empty_like(f), torch.empty(f.shape[1:], device=device),
            torch.empty_like(vel))

    def k4():
        return stream_collide_flat(f, vel, u, s, static, patch, out=bufs, **kw)

    def k1():
        return stream_collide(f, vel, u, s, static, patch, **kw)

    def plain():
        fo, ro, vo = stream_collide_flat_plain(storage.decode_f(f), vel, u, s,
                                               static, patch, **kw)
        if store_bf16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return fo, ro, vo

    a, b, c = stream_collide_flat(f, vel, u, s, static, patch, **kw), k1(), plain()
    torch.cuda.synchronize()
    out = {**state_diff(*a, *c), "tol": K1_TOL[store_bf16],
           "k1": state_diff(*a, *b),
           **bound(*step_work(patch, store_bf16, kw["wall_model"]), device)}
    del a, b, c
    turns = [time_cuda(fn, reps) for fn in (k4, k1, k1, k4)]
    out.update(turns_ms=turns, ms=min(turns[0], turns[3]), k1_ms=min(turns[1], turns[2]))
    turns = [graph_ms(fn, reps) for fn in (k4, k1, k1, k4)]
    out.update(graph_turns_ms=turns, graph_ms=min(turns[0], turns[3]),
               k1_graph_ms=min(turns[1], turns[2]))
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


def check_inplace(patch: PatchLevel, static: Dict, store_bf16: bool, seed: int,
                  kw: Dict, device, reps: int = 20, plain_reps: int = 3) -> Dict:
    """K5 against stream_collide_inplace_plain and against K1 on the card.
    K5 and its plain version overwrite their f, so each runs on its own
    clone of the input.  Returns what check_flat returns, with "same_ptr":
    whether K5 returned the storage it was given, "plain_peak_bytes": the
    peak allocation of the plain step above its inputs, "edge_copy_ms" and
    "step_ms": K5's two launches timed apart, and its "layout" and "attrs"
    (registers, local and shared memory, blocks per SM) at this shape."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    u, s = 0.04, 9
    f0, vel = inp["f"], inp["vel"]

    vel_in = vel.clone()
    # the plain step first, while little else is allocated
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    c = stream_collide_inplace_plain(f0.clone(), vel, u, s, static, patch, **kw)
    torch.cuda.synchronize(device)
    plain_peak = torch.cuda.max_memory_allocated(device) - base
    fk = f0.clone()
    ptr = fk.data_ptr()
    a = stream_collide_inplace(fk, vel, u, s, static, patch, **kw)
    out = {**state_diff(*a, *c), "tol": K1_TOL[store_bf16],
           "same_ptr": a[0].data_ptr() == ptr and bool(torch.equal(a[0], fk)),
           "plain_peak_bytes": int(plain_peak),
           **bound(*step_work(patch, store_bf16, kw["wall_model"]), device)}
    del c
    out["k1"] = state_diff(*a, *stream_collide(f0, vel, u, s, static, patch, **kw))
    out["vel_kept"] = bool(torch.equal(vel, vel_in))
    del a, fk, vel_in
    # timed on one working copy each, which every call steps further on, in
    # turns (K5, K1, K1, K5): "ms" and "k1_ms" are each the better of two
    work = f0.clone()

    def k5():
        return stream_collide_inplace(work, vel, u, s, static, patch, **kw)

    def k1():
        return stream_collide(f0, vel, u, s, static, patch, **kw)

    turns = [time_cuda(fn, reps) for fn in (k5, k1, k1, k5)]
    out["turns_ms"] = turns
    out["ms"], out["k1_ms"] = min(turns[0], turns[3]), min(turns[1], turns[2])
    # K5's two launches, each alone
    out.update(inplace_parts_ms(work, vel, u, s, static, patch, reps, **kw))
    X, Y, Z = patch.interior
    out["layout"] = inplace_layout(X, Y, Z, device, 2 if store_bf16 else 4)
    out["attrs"] = inplace_attrs(store_bf16, out["layout"])
    work_p = f0.clone()
    out["plain_ms"] = time_cuda(
        lambda: stream_collide_inplace_plain(work_p, vel, u, s, static, patch, **kw),
        plain_reps)
    return out


def step_peak_bytes(fn: Callable[[], object], device, graph_set=None) -> int:
    """Bytes allocated at the peak of one call of `fn` above what was live
    before it (its outputs included), plus, where `fn` replays the CUDA
    graphs of `graph_set` (`graphs.GraphSet`), their pool, which a replay
    uses without allocating."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak + (graph_set.pool_bytes if graph_set is not None else 0))


def check_bouzidi(patch: PatchLevel, plan: Dict, store_bf16: bool, seed: int,
                  device, reps: int = 50, plain_reps: int = 10) -> Dict:
    """K2 (one launch over the plan's links, in place) against its plain
    version `apply_bouzidi_links` on the card.  Returns the max-abs error of
    decoded f, the slots changed, the bound of the links' work beside the
    box sweep's ("box_bound_ms"), the bytes allocated at the peak of one
    call ("peak_bytes", 0 expected), ms per call of both, and K2's ms per
    call replayed from a CUDA graph ("graph_ms": no host launch overhead;
    K2 allocates nothing, so it can be captured)."""
    f0 = random_level_inputs(patch, store_bf16, seed, device)["f"]
    fk = bouzidi(f0.clone(), plan)
    fp = apply_bouzidi_links(f0, plan)
    torch.cuda.synchronize()
    err = float((storage.decode_f(fk) - storage.decode_f(fp)).abs().max())
    changed = int((fk != f0).sum())
    del fk, fp
    work = f0.clone()
    S = plan["S"]
    box = bound(*box_work(plan, S.numel() * 4, store_bf16,
                          int(torch.count_nonzero(S))), device)
    out = {"max_abs_err": err, "changed": changed, "tol": K2_TOL[store_bf16],
           "links": len(plan["links"]["a"]), "box_bound_ms": box["bound_ms"],
           **bound(*link_work(plan, store_bf16), device)}
    out["peak_bytes"] = step_peak_bytes(lambda: bouzidi(work, plan), device)
    out["ms"] = time_cuda(lambda: bouzidi(work, plan), reps)
    out["graph_ms"] = graph_ms(lambda: bouzidi(work, plan), reps)
    out["plain_ms"] = time_cuda(lambda: apply_bouzidi_links(f0, plan), plain_reps)
    return out


def slab_inputs(patch: PatchLevel, inp: Dict, static: Dict, bounds: List[int],
                i: int) -> Dict:
    """Slab i of `bounds` cut from whole-level inputs (`random_level_inputs`)
    as the sharded path holds it: f, vel and the statics' x slab, the edge
    planes (27, 2, Y, Z) and (3, 2, Y, Z) from the neighbour slabs' planes
    (zero at the domain ends), and sub-step 0's ghost planes of the slab
    (`parallel.patch_shard.slab_planes`)."""
    from .parallel.patch_shard import slab_planes

    x0, x1 = bounds[i], bounds[i + 1]
    f, vel = inp["f"], inp["vel"]
    _, Y, Z = patch.interior
    fe = torch.zeros((27, 2, Y, Z), dtype=f.dtype, device=f.device)
    ve = torch.zeros((3, 2, Y, Z), dtype=torch.float32, device=f.device)
    if x0 > 0:
        fe[:, 0], ve[:, 0] = f[:, x0 - 1], vel[:, x0 - 1]
    if x1 < patch.interior[0]:
        fe[:, 1], ve[:, 1] = f[:, x1], vel[:, x1]
    planes = slab_planes(inp["iface"], patch, bounds, [f.device] * (len(bounds) - 1))[i]
    return {"f": f[:, x0:x1].contiguous(), "vel": vel[:, x0:x1].contiguous(),
            "static": {k: static[k][x0:x1].contiguous()
                       for k in ("obstacle", "sponge", "wall_dist")},
            "edges": (fe, ve), "x_off": x0, "iface": sub_step_planes(planes, 0)}


def check_shard_step(kind: str, patch: PatchLevel, static: Dict, store_bf16: bool,
                     seed: int, kw: Dict, device, n: int, i: int, reps: int = 20,
                     plain_reps: int = 3) -> Dict:
    """The sharded form of K1 ("k1"), K4 ("flat") or K5 ("inplace") on slab
    i of n of `patch` (`slab_bounds`), against its plain version on the
    same slab inputs (`slab_inputs`; the kernel's tolerance) and against
    the unsharded kernel on the whole level ("whole": the slab's rows, the
    share of stored f entries that differ, 0 expected), on the card.  K5 and
    its plain version each run on their own clone.  Returns what
    check_stream_collide returns, the slab ("slab": (x0, x1)), and the
    bound of the slab's work with its edge planes read."""
    from .parallel.patch_shard import slab_bounds

    b = slab_bounds(patch.interior[0], n)
    x0, x1 = b[i], b[i + 1]
    inp = random_level_inputs(patch, store_bf16, seed, device)
    sl = slab_inputs(patch, inp, static, b, i)
    u, s = 0.04, 9
    fn = {"k1": stream_collide, "flat": stream_collide_flat,
          "inplace": stream_collide_inplace}[kind]
    plain_fn = {"k1": dense_stream_collide, "flat": stream_collide_flat_plain}.get(kind)
    ifk = {"iface": sl["iface"]} if kind == "k1" else {}
    shard = dict(edges=sl["edges"], x_off=x0)

    def kernel(f):
        return fn(f, sl["vel"], u, s, sl["static"], patch, **shard, **ifk, **kw)

    def plain():
        if kind == "inplace":  # K5's plain version, on a clone it overwrites
            return stream_collide_inplace_plain(sl["f"].clone(), sl["vel"], u, s,
                                                sl["static"], patch, **shard, **kw)
        fo, ro, vo = plain_fn(storage.decode_f(sl["f"]), sl["vel"], u, s, sl["static"],
                              patch, edges=(storage.decode_f(sl["edges"][0]),
                                            sl["edges"][1]), x_off=x0, **ifk, **kw)
        if store_bf16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return fo, ro, vo

    a = kernel(sl["f"].clone())
    c = plain()
    ifw = {"iface": sub_step_planes(inp["iface"], 0)} if kind == "k1" else {}
    w = fn(inp["f"].clone(), inp["vel"], u, s, static, patch, **ifw, **kw)
    torch.cuda.synchronize()
    nb, ops = step_work(dataclasses.replace(patch, interior=(x1 - x0,) + tuple(
        patch.interior[1:])), store_bf16, kw["wall_model"])
    Y, Z = patch.interior[1:]
    nb += 2 * Y * Z * (27 * (2 if store_bf16 else 4) + 12)
    out = {**state_diff(*a, *c), "tol": K1_TOL[store_bf16], "slab": (x0, x1),
           "whole": state_diff(a[0], a[1], a[2], w[0][:, x0:x1], w[1][x0:x1],
                               w[2][:, x0:x1]),
           **bound(nb, ops, device)}
    del a, c, w
    work = sl["f"].clone()
    out["ms"] = time_cuda(lambda: kernel(work if kind == "inplace" else sl["f"]), reps)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


def check_bouzidi_shard(patch: PatchLevel, plan: Dict, store_bf16: bool, seed: int,
                        bounds: List[int], device, reps: int = 50,
                        plain_reps: int = 10) -> Dict:
    """K2's sharded form over the slabs of `bounds` (every slab's halo
    gathered, then K2 per slab over the links it owns) against its plain
    version per slab (the kernel's tolerance) and against the unsharded K2
    on the whole level ("whole": the slabs joined, the share of stored f
    entries that differ, 0 expected), on the card.  Returns the errors, the
    links and halo values per slab, the bound of the links' work, and ms
    per correction of the whole level (halos and every slab's launch) and
    of the plain version."""
    from .parallel.patch_shard import bouzidi_halos, shard_bouzidi_plan

    f0 = random_level_inputs(patch, store_bf16, seed, device)["f"]
    n = len(bounds) - 1
    shards = [{"bouzidi": sp} for sp in shard_bouzidi_plan(plan, bounds, [device] * n)]
    parts0 = [f0[:, bounds[i]:bounds[i + 1]].contiguous() for i in range(n)]

    def sharded(parts):
        halos = bouzidi_halos(shards, parts)
        return [bouzidi(p, sh["bouzidi"], h) if sh["bouzidi"] is not None else p
                for p, sh, h in zip(parts, shards, halos)]

    got = sharded([p.clone() for p in parts0])
    halos = bouzidi_halos(shards, parts0)
    plain = [apply_bouzidi_links(p, sh["bouzidi"], h) if sh["bouzidi"] is not None
             else p for p, sh, h in zip(parts0, shards, halos)]
    whole = bouzidi(f0.clone(), plan)
    torch.cuda.synchronize()
    g = torch.cat(got, dim=1)
    err = float((storage.decode_f(g) - storage.decode_f(torch.cat(plain, dim=1)))
                .abs().max())
    out = {"max_abs_err": err, "tol": K2_TOL[store_bf16],
           "changed": int((g != f0).sum()),
           "whole": {"diff_frac": float((g != whole).float().mean()),
                     "max_abs_err": float((storage.decode_f(g) - storage.decode_f(whole))
                                          .abs().max())},
           "links": [0 if sh["bouzidi"] is None else len(sh["bouzidi"]["links"]["a"])
                     for sh in shards],
           "halo": [0 if sh["bouzidi"] is None else sh["bouzidi"]["n_halo"]
                    for sh in shards],
           **bound(*link_work(plan, store_bf16), device)}
    del got, plain, whole, g
    work = [p.clone() for p in parts0]
    out["ms"] = time_cuda(lambda: sharded(work), reps)
    out["plain_ms"] = time_cuda(
        lambda: [apply_bouzidi_links(p, sh["bouzidi"], h) for p, sh, h in
                 zip(parts0, shards, halos) if sh["bouzidi"] is not None], plain_reps)
    return out


def check_bouzidi_ab(patch: PatchLevel, plan: Dict, store_bf16: bool, seed: int,
                     device, reps: int = 50, plain_reps: int = 10) -> Dict:
    """K6 (one launch over the two-array plan's links, in place; A and B in
    the storage dtype) against its plain version `apply_bouzidi_ab_links`
    and against K2 on the same S, on the card.  Returns the max-abs errors
    of decoded f against both, the slots changed, the links' bound (two
    coefficients of the storage type each) beside the box sweep's, the
    bytes allocated at the peak of one call ("peak_bytes", 0 expected),
    and ms per call of K6 and K2, eager in turns (K6, K2, K2, K6) and
    replayed from a CUDA graph ("graph_ms", "k2_graph_ms"), and of the
    plain version."""
    f0 = random_level_inputs(patch, store_bf16, seed, device)["f"]
    pab = bouzidi_ab_plan(plan, f0.dtype)
    fk = bouzidi_ab(f0.clone(), pab)
    fp = apply_bouzidi_ab_links(f0, pab)
    f2 = bouzidi(f0.clone(), plan)
    torch.cuda.synchronize()
    err = float((storage.decode_f(fk) - storage.decode_f(fp)).abs().max())
    err_k2 = float((storage.decode_f(fk) - storage.decode_f(f2)).abs().max())
    changed = int((fk != f0).sum())
    del fk, fp, f2
    elem = pab["A"].element_size()
    box = bound(*box_work(plan, 2 * pab["A"].numel() * elem, store_bf16,
                          len(pab["links"]["cell"])), device)
    out = {"max_abs_err": err, "k2_err": err_k2, "changed": changed,
           "tol": K2_TOL[store_bf16], "links": len(pab["links"]["cell"]),
           "box_bound_ms": box["bound_ms"],
           **bound(*link_work(pab, store_bf16, 2 * elem), device)}
    work = f0.clone()

    def k6():
        return bouzidi_ab(work, pab)

    def k2():
        return bouzidi(work, plan)

    out["peak_bytes"] = step_peak_bytes(k6, device)
    turns = [time_cuda(fn, reps) for fn in (k6, k2, k2, k6)]
    out.update(turns_ms=turns, ms=min(turns[0], turns[3]), k2_ms=min(turns[1], turns[2]))
    turns = [graph_ms(fn, reps) for fn in (k6, k2, k2, k6)]
    out.update(graph_turns_ms=turns, graph_ms=min(turns[0], turns[3]),
               k2_graph_ms=min(turns[1], turns[2]))
    out["plain_ms"] = time_cuda(lambda: apply_bouzidi_ab_links(f0, pab), plain_reps)
    return out


def within_k3_tol(r: Dict, store_bf16: bool) -> bool:
    return (r["finite"] and r["max_abs_err"] < K3_TOL[store_bf16]
            and (not store_bf16 or r["diff_frac"] < K3_MAX_DIFF_FRAC))


def check_fused_pair(patch: PatchLevel, static: Dict, plan, store_bf16: bool,
                     seed: int, kw: Dict, device, iface=None, reps: int = 20,
                     plain_reps: int = 3) -> Dict:
    """K3 + K2 against fused_pair_plain + the plain correction on the card.
    `iface` is (iface_a, iface_b) or None for random, distinct ghost planes
    of the two sub-steps (`random_level_inputs`).  Returns the max-abs
    errors of f (decoded), rho and vel, the share of stored f entries that
    differ, ms per call of K3 alone, of the unfused kernels K1 -> K2 -> K1
    (timed in turns in this call) and of the plain pair, and K3's
    "attrs"."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    if iface is None:
        iface = tuple(sub_step_planes(inp["iface"], n) for n in (0, 1))
    if_a, if_b = iface
    u, s = (0.04, 0.041), (9, 10)
    f, vel = inp["f"], inp["vel"]

    def k3():
        return fused_pair(f, vel, u, s, static, patch, plan, iface_a=if_a,
                          iface_b=if_b, **kw)

    def unfused():
        fa, _, va = stream_collide(f, vel, u[0], s[0], static, patch,
                                   iface=if_a, **kw)
        if plan is not None:
            fa = bouzidi(fa, plan)
        return stream_collide(fa, va, u[1], s[1], static, patch, iface=if_b,
                              **kw)

    def plain():
        return fused_pair_plain(f, vel, u, s, static, patch, plan,
                                iface_a=if_a, iface_b=if_b, **kw)

    fk, rk, vk = k3()
    fu, ru, vu = unfused()
    fp, rp, vp = plain()
    if plan is not None:
        fk, fu = bouzidi(fk, plan), bouzidi(fu, plan)
        fp = apply_bouzidi_dense(fp, plan)
    torch.cuda.synchronize()
    out = state_diff(fk, rk, vk, fp, rp, vp)
    out["unfused"] = state_diff(fk, rk, vk, fu, ru, vu)
    out["tol"] = K3_TOL[store_bf16]
    nbytes, ops = step_work(patch, store_bf16, kw["wall_model"], sub_steps=2)
    if plan is not None:  # step A's correction between the sub-steps
        links = int(torch.count_nonzero(plan["S"]))
        nbytes, ops = nbytes + plan["S"].numel() * 4, ops + LINK_OPS * links
    out.update(bound(nbytes, ops, device))
    del fk, rk, vk, fu, ru, vu, fp, rp, vp
    # in turns (K3, unfused, unfused, K3): each time the better of two
    turns = [time_cuda(fn, reps) for fn in (k3, unfused, unfused, k3)]
    out["turns_ms"] = turns
    out["ms"], out["unfused_ms"] = min(turns[0], turns[3]), min(turns[1], turns[2])
    out["attrs"] = fused_pair_attrs(store_bf16)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


# momentum exchange: a float32 sum against its float64 value, bound by the
# summation order: |device - float64| <= MEM_REL * sum over the summed
# links of |link contribution| (a plain relative bound is wrong for a sum
# that cancels)
MEM_REL = 1e-5


def mem_float64(f: torch.Tensor, ctx) -> Dict[str, np.ndarray]:
    """The momentum-exchange result of `ctx`'s links (`ops.forces.MEMContext`)
    on a host copy of f, in float64: "F", "M" (3,) and "force_map"
    (3, n_tri) in newtons as `compute_aerodynamics_mem` reports them
    (rest flux added, half models doubled), and beside each its bound,
    MEM_REL x the sum of its links' |contribution| (same scale)."""
    fh = f.detach().cpu().double().numpy().reshape(-1)
    vo = fh[ctx.idx_out.cpu().numpy()]
    vi = fh[ctx.idx_in.cpu().numpy()]
    if not ctx.g_storage:
        w = ctx.w_k.cpu().double().numpy()
        vo, vi = vo - w, vi - w
    c = ctx.c.cpu().double().numpy()
    r = ctx.r.cpu().double().numpy()
    tri = ctx.tri.cpu().numpy()
    dF = (vo + vi)[None, :] * c
    dM = np.cross(r.T, dF.T).T
    F_tri = np.zeros((3, ctx.n_tri))
    abs_tri = np.zeros((3, ctx.n_tri))
    np.add.at(F_tri.T, tri, dF.T)
    np.add.at(abs_tri.T, tri, np.abs(dF).T)
    s = ctx.force_scale
    F = (dF.sum(axis=1) + ctx.rest_F) * s
    M = (dM.sum(axis=1) + ctx.rest_M) * s
    F_bound = MEM_REL * np.abs(dF).sum(axis=1) * s
    M_bound = MEM_REL * np.abs(dM).sum(axis=1) * s
    if ctx.symmetric:
        F, F_bound = (np.array([2 * F[0], 0.0, 2 * F[2]]),
                      np.array([2 * F_bound[0], 0.0, 2 * F_bound[2]]))
        M, M_bound = np.array([0.0, 2 * M[1], 0.0]), np.array([0.0, 2 * M_bound[1], 0.0])
    return {"F": F, "M": M, "force_map": (F_tri + ctx.rest_F_tri) * s,
            "F_bound": F_bound, "M_bound": M_bound,
            "map_bound": MEM_REL * abs_tri * s}


def mem_errors(res, ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """A ForceResult's F, M and force map against `mem_float64`: the largest
    |difference| / bound of each ("ok" when all are at most 1)."""
    tiny = 1e-300  # a component whose bound is 0 (a zeroed half-model one)

    def ratio(got, want, bnd):
        return float(np.max(np.abs(np.asarray(got) - want) / np.maximum(bnd, tiny)))

    out = {"F": ratio([res.Fx, res.Fy, res.Fz], ref["F"], ref["F_bound"]),
           "M": ratio([res.Mx, res.My, res.Mz], ref["M"], ref["M_bound"]),
           "force_map": ratio(res.force_map, ref["force_map"], ref["map_bound"])}
    out["ok"] = max(out.values()) <= 1.0
    return out

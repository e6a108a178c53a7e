"""Kernel-against-plain checks and timings on the card.

Shared by `chip_smoke.py` and the CUDA-only tests: random inputs made from
a numpy seed go through a CUDA kernel and through its plain PyTorch
version on the same device; the result is the max-abs deviation and both
times from CUDA events.  Tolerances are the JAX package's own for the
same layers (`tests/test_patch_pallas.py:114, :400, :439`):

  K1 stream-collide: float32 < 1e-5; bf16 g-storage < 2e-3 (decoded f)
  K2 Bouzidi:        float32 < 1e-6; bf16 g-storage < 2e-3 (decoded f)
  K4 flat step, K5 in-place step: float32 < 1e-5; bf16 g-storage < 2e-3
                     (decoded f), against their plain versions (the
                     reference's flat and 2-D kernels are held to the XLA
                     path at these bounds, tests/test_patch_pallas.py:157);
                     against K1, which runs the same per-cell code, the
                     share of stored f entries that differ is reported
                     (expected 0)
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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import CaseConfig, load_case_config
from open_ludwig_tpu.core.patch import (
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.scaling import DomainParams, compute_domain_params

from . import lattice as lat
from .core.patch import build_patches
from .ops import storage
from .ops.cuda_step import (
    bouzidi,
    fused_pair,
    stream_collide,
    stream_collide_flat,
    stream_collide_inplace,
)
from .ops.dense_step import (
    apply_bouzidi_dense,
    dense_stream_collide,
    fused_pair_plain,
    stream_collide_flat_plain,
    stream_collide_inplace_plain,
)

K1_TOL = {False: 1e-5, True: 2e-3}  # keyed by store_bf16
K2_TOL = {False: 1e-6, True: 2e-3}
K3_TOL = {False: 1e-5, True: 2e-3}
K3_MAX_DIFF_FRAC = 0.01  # bf16: share of stored f entries that may differ


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


def random_level_inputs(patch: PatchLevel, store_bf16: bool, seed: int,
                        device) -> Dict:
    """f (storage dtype), vel and float32 f-space ghost planes for every
    interface face of `patch`, perturbed around rest; drawn on `device` from
    `seed` (a 63.7M-cell level takes no host round trip)."""
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
        shp = (27, sh[t[0]] + 2, sh[t[1]] + 2)
        planes[fc] = w.view(27, 1, 1) * (1 + 0.03 * randn(shp))
    return {"f": f, "vel": vel, "iface": planes}


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


def check_stream_collide(patch: PatchLevel, static: Dict, store_bf16: bool,
                         seed: int, kw: Dict, device, reps: int = 20,
                         plain_reps: int = 3) -> Dict:
    """K1 against dense_stream_collide on the card.  Returns max-abs errors
    of f (decoded), rho and vel, and ms per call of both."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    u, s = 0.04, 9

    def kernel():
        return stream_collide(inp["f"], inp["vel"], u, s, static, patch,
                              iface=inp["iface"], **kw)

    def plain():
        fo, ro, vo = dense_stream_collide(
            storage.decode_f(inp["f"]), inp["vel"], u, s, static, patch,
            iface=inp["iface"], **kw)
        if store_bf16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return fo, ro, vo

    fk, rk, vk = kernel()
    fp, rp, vp = plain()
    torch.cuda.synchronize()
    out = {**state_diff(fk, rk, vk, fp, rp, vp), "tol": K1_TOL[store_bf16]}
    del fk, rk, vk, fp, rp, vp
    out["ms"] = time_cuda(kernel, reps)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


def check_flat(patch: PatchLevel, static: Dict, store_bf16: bool, seed: int,
               kw: Dict, device, reps: int = 20, plain_reps: int = 3) -> Dict:
    """K4 against stream_collide_flat_plain and against K1 on the card, from
    one input (A -> B: nothing is modified).  Returns max-abs errors against
    the plain version, the comparison with K1 ("k1": errors and the share
    of stored f entries that differ), and ms per call of K4, K1 and plain."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    u, s = 0.04, 9
    f, vel = inp["f"], inp["vel"]

    def k4():
        return stream_collide_flat(f, vel, u, s, static, patch, **kw)

    def k1():
        return stream_collide(f, vel, u, s, static, patch, **kw)

    def plain():
        fo, ro, vo = stream_collide_flat_plain(storage.decode_f(f), vel, u, s,
                                               static, patch, **kw)
        if store_bf16:
            fo = storage.encode_f(fo, storage.STORE_BF16)
        return fo, ro, vo

    a, b, c = k4(), k1(), plain()
    torch.cuda.synchronize()
    out = {**state_diff(*a, *c), "tol": K1_TOL[store_bf16],
           "k1": state_diff(*a, *b)}
    del a, b, c
    out["ms"] = time_cuda(k4, reps)
    out["k1_ms"] = time_cuda(k1, reps)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out


def check_inplace(patch: PatchLevel, static: Dict, store_bf16: bool, seed: int,
                  kw: Dict, device, reps: int = 20, plain_reps: int = 3) -> Dict:
    """K5 against stream_collide_inplace_plain and against K1 on the card.
    K5 and its plain version overwrite their f, so each runs on its own
    clone of the input.  Returns what check_flat returns, with "same_ptr":
    whether K5 returned the storage it was given, and "plain_peak_bytes":
    the peak allocation of the plain step above its inputs."""
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
           "plain_peak_bytes": int(plain_peak)}
    del c
    out["k1"] = state_diff(*a, *stream_collide(f0, vel, u, s, static, patch, **kw))
    out["vel_kept"] = bool(torch.equal(vel, vel_in))
    del a, fk, vel_in
    # timed on one working copy each, which every call steps further on
    work = f0.clone()
    out["ms"] = time_cuda(
        lambda: stream_collide_inplace(work, vel, u, s, static, patch, **kw), reps)
    out["k1_ms"] = time_cuda(
        lambda: stream_collide(f0, vel, u, s, static, patch, **kw), reps)
    work_p = f0.clone()
    out["plain_ms"] = time_cuda(
        lambda: stream_collide_inplace_plain(work_p, vel, u, s, static, patch, **kw),
        plain_reps)
    return out


def step_peak_bytes(fn: Callable[[], object], device) -> int:
    """Bytes allocated at the peak of one call of `fn` above what was live
    before it (its outputs included)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return int(peak)


def check_bouzidi(patch: PatchLevel, plan: Dict, store_bf16: bool, seed: int,
                  device, reps: int = 50, plain_reps: int = 10) -> Dict:
    """K2 (snapshot + kernel, in place) against apply_bouzidi_dense on the
    card.  Returns the max-abs error of decoded f and ms per call of both."""
    f0 = random_level_inputs(patch, store_bf16, seed, device)["f"]
    fk = bouzidi(f0.clone(), plan)
    fp = apply_bouzidi_dense(f0, plan)
    torch.cuda.synchronize()
    err = float((storage.decode_f(fk) - storage.decode_f(fp)).abs().max())
    changed = int((fk != f0).sum())
    del fk, fp
    work = f0.clone()
    out = {"max_abs_err": err, "changed": changed, "tol": K2_TOL[store_bf16]}
    out["ms"] = time_cuda(lambda: bouzidi(work, plan), reps)
    out["plain_ms"] = time_cuda(lambda: apply_bouzidi_dense(f0, plan), plain_reps)
    return out


def within_k3_tol(r: Dict, store_bf16: bool) -> bool:
    return (r["finite"] and r["max_abs_err"] < K3_TOL[store_bf16]
            and (not store_bf16 or r["diff_frac"] < K3_MAX_DIFF_FRAC))


def check_fused_pair(patch: PatchLevel, static: Dict, plan, store_bf16: bool,
                     seed: int, kw: Dict, device, iface=None, reps: int = 20,
                     plain_reps: int = 3) -> Dict:
    """K3 + K2 against fused_pair_plain + the plain correction on the card.
    `iface` is (iface_a, iface_b) or None for random, distinct ghost planes
    of the two sub-steps.  Returns the max-abs errors of f (decoded), rho
    and vel, the share of stored f entries that differ, and ms per call of
    K3 alone, of the unfused kernels K1 -> K2 -> K1, and of the plain pair."""
    inp = random_level_inputs(patch, store_bf16, seed, device)
    if iface is None:
        iface = (inp["iface"],
                 random_level_inputs(patch, store_bf16, seed + 1, device)["iface"])
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
    del fk, rk, vk, fu, ru, vu, fp, rp, vp
    out["ms"] = time_cuda(k3, reps)
    out["unfused_ms"] = time_cuda(unfused, reps)
    out["plain_ms"] = time_cuda(plain, plain_reps)
    return out

"""The reference's largest size row ("216M cells") on one card.

    python -m open_ludwig_torch.tools.plan_216m [--res 68] [--steps 20]
        [--device cuda|cpu] [--cases DIR] [--out plan_216m.json]

The port's counterpart of `tools/plan_216m.py`.  The reference's size
table ends at 216M cells, claimed at 300 MLUPS on an RTX 4090 (reference:
README.md:508-509).  This builds the row's configuration, the sweep's
scaled up (`cases.make_case_sphere("1M")` at N = `--res`, one level, bf16
storage, `domain_tile_snap`; 640x592x640 = 242.5M cells at N = 68), then:

  1. prints the per-level device-memory report (`hbm_report_patches`), the
     planner's estimate from the levels alone (`memory.case_bytes` for
     the level's kernel, what the card's rule reads, without the plans) and,
     on the card, its capacity (`runner --plan`'s: the card's memory less
     its reserve, in cells, `memory.level_capacity`);
  2. on one perturbed state, one coarse step on the kernel the card's rule
     picks (`ops/engine.card_engines`: K1 where the row's A -> B step fits
     the card) and one with the other of K1 / K5 forced (unfused, each with
     K2 after it), which must be bit-equal, with their launch counts
     (K5's plain version does not fit beside the row: 33 GB at 63.7M
     cells);
  3. `--steps` coarse steps from rest through `runner.solve_case`: ms per
     coarse step and MLUPS from the runner's CUDA events over the batches
     after the first, and the peak `torch.cuda.max_memory_allocated`
     beside the estimate.

Writes one JSON object to `--out` and prints it.  `--device cpu` runs the
same on the plain PyTorch path (at a small `--res`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import torch


def row_case(case_dir: str, res: int, steps: int) -> str:
    """The single-level bf16 sphere row at N = `res` (the reference's
    216M-cell row at 68), forces and diagnostics every steps / 2."""
    from ..cases import make_case_sphere

    return make_case_sphere(case_dir, "1M", surface_resolution=res, num_levels=1,
                            steps=steps, ramp_steps=max(steps // 2, 1),
                            output_freq=10**9, diag_freq=max(steps // 2, 1),
                            precision="bfloat16", domain_tile_snap=True)


def build_row(case_dir: str, dev):
    """(cfg, params, levels, statics on `dev`, host build seconds)."""
    from ..config import load_case_config
    from ..core.patch import build_patches
    from ..geometry import load_mesh
    from ..scaling import compute_domain_params
    from ..solver_dense import build_patch_statics

    t0 = time.time()
    cfg = load_case_config(case_dir)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, levels, dev)
    return cfg, params, levels, statics, time.time() - t0


def perturbed_states(levels, precision: str, seed: int, dev) -> List[Dict]:
    """States around rest drawn on `dev` from `seed`, one velocity slot at a
    time (no (27, X, Y, Z) float32 temporary at 216M cells)."""
    from .. import lattice as lat
    from ..ops import storage

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for p in levels:
        sh = tuple(p.interior)
        f = torch.empty((27,) + sh, dtype=storage.f_dtype(precision), device=dev)
        for k in range(27):
            w = float(lat.W[k])
            fk = w * (1 + 0.03 * torch.randn(sh, generator=gen, device=dev))
            # bf16 storage holds g = f - w (`ops.storage.encode_f`)
            f[k] = fk - w if f.dtype == torch.bfloat16 else fk
        out.append({"f": f,
                    "rho": 1 + 0.01 * torch.randn(sh, generator=gen, device=dev),
                    "vel": 0.02 * torch.randn((3,) + sh, generator=gen, device=dev)})
    return out


def states_equal(a: List[Dict], b: List[Dict]) -> bool:
    """Level states equal bit for bit (bf16 compared as its bits)."""
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return len(a) == len(b) and all(torch.equal(bits(x[k]), bits(y[k]))
                                    for x, y in zip(a, b) for k in ("f", "rho", "vel"))


def card() -> Dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if not torch.cuda.is_available():
        return {"name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi.splitlines()[0]}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from .. import memory
    from ..ops import cuda_step, storage
    from ..runner import resolve_device, solve_case
    from ..solver_dense import (hbm_report_patches, hbm_total_patches,
                                make_batch_runner_dense)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=68)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cases", default="validation_runs")
    ap.add_argument("--out", default=os.path.join("validation_runs", "plan_216m.json"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    case = row_case(os.path.join(args.cases, f"row_{args.res}"), args.res, args.steps)
    cfg, params, levels, statics, build_s = build_row(case, dev)
    p = levels[0]
    cells = sum(q.n_cells for q in levels)
    engine = statics[0]["engine"]
    out = {"reference": "README.md:508-509 (300 MLUPS at 216M cells, RTX 4090)",
           "res": args.res, "cells": cells, "interior": list(p.interior),
           "precision": cfg.precision, "engine": engine,
           "engine_why": statics[0]["engine_why"], "build_s": build_s,
           "card": card(), "device": str(dev)}
    print(f"[216M] N={args.res}: {tuple(p.interior)} = {cells / 1e6:.1f}M cells, "
          f"{cfg.precision}, kernel {engine} ({statics[0]['engine_why']}); host "
          f"build {build_s:.1f} s", flush=True)

    # ---- 1. memory: the report, the planner's estimate, the capacity ----
    report = hbm_report_patches(levels, statics, cfg.precision, dev)
    print(report, flush=True)
    est = memory.case_bytes(levels, [st["engine"] for st in statics],
                            cfg.precision)["device"]
    fb = storage.f_dtype(cfg.precision).itemsize
    out.update(report_bytes=hbm_total_patches(levels, statics, cfg.precision, dev),
               estimate_bytes=est, bytes_per_cell=memory.bytes_per_cell(fb, engine))
    if cuda:
        per_card = memory.card_capacity(dev)
        cap = {eng: memory.level_capacity(per_card, fb, eng) for eng in ("k1", "inplace")}
        out["capacity_cells"] = cap
        print(f"[216M] estimate {est / 1e9:.2f} GB ({out['bytes_per_cell']:.1f} B a cell);"
              f" capacity of this card ({per_card / 1e9:.1f} GB, its memory less the "
              f"reserve): {cap['k1'] / 1e6:.0f}M cells on A->B levels, "
              f"{cap['inplace'] / 1e6:.0f}M in place -> this row uses "
              f"{100 * cells / cap[engine if engine == 'inplace' else 'k1']:.0f}%",
              flush=True)
    else:
        print(f"[216M] estimate {est / 1e9:.3f} GB; capacity: not estimated on the "
              "CPU (the card's memory sets it)", flush=True)

    # ---- 2. the kernel picked against the other of K1 / K5, one step ----
    other = "k1" if engine == "inplace" else "inplace"
    forced = [{**st, "engine": other} for st in statics]
    start = perturbed_states(levels, cfg.precision, 7, dev)
    finals, launches = {}, {}
    for eng, sts in ((engine, statics), (other, forced)):
        run = make_batch_runner_dense(cfg, params, levels, sts, fuse2=False)
        cuda_step.reset_launches()
        finals[eng] = run([{**s, "f": s["f"].clone()} for s in start], 1, 1)
        launches[eng] = {k: v for k, v in cuda_step.executed_launches().items() if v}
        del run
    equal = states_equal(finals[engine], finals[other])
    out.update(k1_k5_equal=equal, k1_k5_launches=launches)
    print(f"[216M] one coarse step from a perturbed state: {engine} against {other} "
          f"forced (each with K2 after it, unfused) bit-equal: {equal} | launches "
          f"{launches}", flush=True)
    del finals, start, forced, statics
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    if not equal:
        raise RuntimeError("K1 and K5 disagree on the row")

    # ---- 3. the row through the runner ----
    if cuda:
        live0 = torch.cuda.memory_allocated(dev)
        held0 = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = solve_case(cfg, device=args.device)
    out["solve_wall_s"] = time.time() - t0
    stats = res.final_stats
    finite = bool(torch.isfinite(torch.tensor([stats.rho_min, stats.rho_max,
                                               stats.v_max])).all())
    out.update(steps=res.steps, rho_min=stats.rho_min, rho_max=stats.rho_max,
               finite=finite)
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - live0
        # what the allocator reserved from the card at its peak, and what the
        # card holds beyond torch's reservations (the CUDA context): the
        # card's reserve must cover both beyond the estimate
        out["reserved_bytes"] = torch.cuda.max_memory_reserved(dev) - held0
        free, total = torch.cuda.mem_get_info(dev)
        out["context_bytes"] = total - free - torch.cuda.memory_reserved(dev)
        out["reserve_bytes"] = memory.card_reserve(total)
        win = res.windows[1:]  # the first batch carries the warm-up
        n = sum(b - a + 1 for a, b, _ in win)
        ms = sum(t for _, _, t in win) / n
        out.update(ms_per_coarse_step=ms, steps_timed=n,
                   mlups=res.updates_per_coarse / ms / 1e3)
        print(f"[216M] solve_case: {res.steps} coarse steps, {n} timed after the "
              f"first batch: {ms:.3f} ms per coarse step, {out['mlups']:.0f} MLUPS "
              f"(one level: MLUPS-su = MLUPS-ref) | peak allocated "
              f"{out['peak_bytes'] / 1e9:.2f} GB against the estimate "
              f"{est / 1e9:.2f} GB, reserved {out['reserved_bytes'] / 1e9:.2f} GB + "
              f"context {out['context_bytes'] / 1e9:.2f} GB against the estimate + "
              f"the card's reserve {(est + out['reserve_bytes']) / 1e9:.2f} GB | rho {stats.rho_min:.4f}..{stats.rho_max:.4f} | "
              f"run {out['solve_wall_s']:.1f} s with its host set-up", flush=True)
    else:
        print(f"[216M] solve_case on the CPU: {res.steps} coarse steps, rho "
              f"{stats.rho_min:.4f}..{stats.rho_max:.4f} (times: not measured on "
              "the CPU)", flush=True)
    if not (finite and 0.5 < stats.rho_min and stats.rho_max < 1.5):
        raise RuntimeError(f"the row did not stay finite and stable: {stats}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

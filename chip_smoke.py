#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (open_ludwig_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. device: CUDA must be available; prints the card, `nvidia-smi` name and
     power limit, and the toolchain;
  2. build: K1 (csrc/stream_collide.cu) and K2 (csrc/bouzidi.cu) with nvcc
     for sm_90a into build/kernels/;
  3. K1 against its plain PyTorch version on the card, on the bench case's
     levels (wall model, sponge blend, inlet noise 0.02, every face type)
     and on a 10.8M-cell single-level sweep shape, float32 and bf16;
  4. K2 against its plain version on the bench case's own Bouzidi box;
  5. the slice: `open_ludwig_torch.runner.solve_case` on the bench case
     (sphere Re~1M, N=25, 3 levels + wake, wall model, Bouzidi, bf16
     g-storage) for 400 coarse steps: finite CSVs, rho_min in (0.5, 1.5),
     launch counts K1 = 7 x steps and K2 = 4 x steps, and MLUPS-su /
     MLUPS-ref from CUDA events over the post-warm-up intervals.
Prints one JSON line of kernel results, then, as its last line,
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.
"""

import csv
import json
import logging
import os
import subprocess
import sys
import tempfile
import time


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require(ok: bool, what) -> None:
    """Fail the phase: raises (not assert, which -O would strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2

    import numpy as np

    from open_ludwig_torch import checks
    from open_ludwig_torch.ops import build, cuda_step
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver_dense import build_patch_statics

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)

    # ---- 1. device ----
    try:
        import yaml  # noqa: F401  (config.py and cases.py read YAML)
        has_yaml = True
    except ImportError:
        has_yaml = False
    print(f"[1 device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | nvcc {build.nvcc_path()} | yaml "
          f"{'yes' if has_yaml else 'NO'}", flush=True)

    # ---- 2. build ----
    for kname in ("stream_collide", "bouzidi"):
        b = build.load(kname)
        res = [ln.strip() for ln in b.ptxas_log.splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"[2 build] {kname}: {b.seconds:.1f} s -> {b.path}", flush=True)
        for ln in res:
            print(f"[2 build]   {ln}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        cfg, mesh, params, levels = checks.bench_case(os.path.join(tmp, "bench"))
        statics = build_patch_statics(cfg, levels, dev)
        print(f"[3 K1] bench case built in {time.time() - t0:.1f} s: "
              + ", ".join(f"L{p.level_id} {p.interior}" for p in levels), flush=True)
        kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                  inlet_turbulence=0.02, wall_model=True, sponge_blend=True)

        # ---- 3. K1 against plain on the bench levels ----
        cases = checks.bench_k1_cases(levels, statics)
        k1 = {}
        for label, patch, static in cases:
            for bf16 in (False, True):
                r = checks.check_stream_collide(patch, static, bf16, seed=17,
                                                kw=kw, device=dev)
                k1[(label, bf16)] = r
                n = patch.n_cells
                print(f"[3 K1] {label} {patch.interior} {'bf16' if bf16 else 'f32 '}"
                      f" err f/rho/vel {r['err']['f']:.2e}/{r['err']['rho']:.2e}/"
                      f"{r['err']['vel']:.2e} (tol {r['tol']:.0e}) | kernel "
                      f"{r['ms']:.4f} ms ({n / r['ms'] / 1e3:.0f} MLUPS) | plain "
                      f"{r['plain_ms']:.3f} ms", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"],
                        ("K1", label, bf16, r["err"], r["finite"]))

        # ---- 3b. K1 on the 10.8M-cell single-level sweep shape ----
        t0 = time.time()
        _, _, _, sweep = checks.bench_case(
            os.path.join(tmp, "sweep"), surface_resolution=25, num_levels=1,
            precision="float32")
        sweep_static = build_patch_statics(cfg, sweep, dev)[0]
        print(f"[3 K1] sweep shape {sweep[0].interior} ({sweep[0].n_cells / 1e6:.1f}M"
              f" cells) built in {time.time() - t0:.1f} s", flush=True)
        for bf16 in (False, True):
            r = checks.check_stream_collide(sweep[0], sweep_static, bf16, seed=18,
                                            kw=kw, device=dev, reps=5, plain_reps=2)
            k1[("sweep", bf16)] = r
            print(f"[3 K1] sweep {'bf16' if bf16 else 'f32 '} err f/rho/vel "
                  f"{r['err']['f']:.2e}/{r['err']['rho']:.2e}/{r['err']['vel']:.2e}"
                  f" | kernel {r['ms']:.3f} ms ({sweep[0].n_cells / r['ms'] / 1e3:.0f}"
                  f" MLUPS) | plain {r['plain_ms']:.3f} ms", flush=True)
            require(r["finite"] and r["max_abs_err"] < r["tol"],
                    ("K1 sweep", bf16, r["err"], r["finite"]))
        del sweep, sweep_static
        torch.cuda.empty_cache()

        # ---- 4. K2 against plain on the bench Bouzidi box ----
        plan = statics[2]["bouzidi"]
        k2 = {}
        for bf16 in (False, True):
            r = checks.check_bouzidi(levels[2], plan, bf16, seed=19, device=dev)
            k2[bf16] = r
            print(f"[4 K2] box {tuple(plan['dim'])} {'bf16' if bf16 else 'f32 '} err "
                  f"{r['max_abs_err']:.2e} (tol {r['tol']:.0e}, {r['changed']} slots "
                  f"changed) | kernel+snapshot {r['ms']:.4f} ms | plain "
                  f"{r['plain_ms']:.3f} ms", flush=True)
            require(r["changed"] > 0 and r["max_abs_err"] < r["tol"], ("K2", bf16, r))

        # ---- 5. the slice through the runner ----
        cuda_step.reset_launches()
        res = solve_case(cfg, device="cuda")
        launches = dict(cuda_step.LAUNCHES)
        steps = cfg.steps
        print(f"[5 slice] launches {launches} over {steps} coarse steps", flush=True)
        require(launches["stream_collide"] == 7 * steps, ("K1 launches", launches))
        require(launches["bouzidi"] == 4 * steps, ("K2 launches", launches))
        for fname in ("convergence.csv", "forces.csv"):
            with open(os.path.join(cfg.output_path, fname)) as fh:
                rows = list(csv.DictReader(fh))
            require(len(rows) > 0, (fname, "no rows"))
            for row in rows:
                vals = [float(v) for k, v in row.items() if k != "Walltime"]
                require(bool(np.all(np.isfinite(vals))), (fname, row))
        rmin = res.final_stats.rho_min
        require(0.5 < rmin < 1.5 and np.isfinite(res.final_stats.v_max),
                ("diagnostics", res.final_stats))
        win = res.windows[1:]  # the first interval carries the warm-up
        n_steps = sum(b - a + 1 for a, b, _ in win)
        sec = sum(ms for _, _, ms in win) / 1e3
        su = res.updates_per_coarse * n_steps / sec / 1e6
        ref = res.total_cells * n_steps / sec / 1e6
        print(f"[5 slice] {res.total_cells / 1e6:.3f}M cells, "
              f"{res.updates_per_coarse / 1e6:.3f}M site updates per coarse step | "
              f"{n_steps} steps after warm-up in {sec:.3f} s (CUDA events) -> "
              f"{su:.1f} MLUPS-su, {ref:.1f} MLUPS-ref | {sec / n_steps * 1e3:.3f} "
              f"ms/coarse step | rho_min {rmin:.4f} | Cd "
              f"{res.final_forces.Cd:.4f} | card: {smi}", flush=True)

    kernels = [
        {"name": "stream_collide", "route": "cuda",
         "source": "open_ludwig_torch/csrc/stream_collide.cu",
         "replaces": "open_ludwig_tpu/ops/pallas_step.py:247",
         "launches": launches["stream_collide"],
         "max_abs_err": max(r["max_abs_err"] for (lab, bf), r in k1.items() if bf),
         "ms": k1[("L3", True)]["ms"], "plain_ms": k1[("L3", True)]["plain_ms"]},
        {"name": "bouzidi", "route": "cuda",
         "source": "open_ludwig_torch/csrc/bouzidi.cu",
         "replaces": "open_ludwig_tpu/ops/pallas_step.py:62",
         "launches": launches["bouzidi"],
         "max_abs_err": k2[True]["max_abs_err"],
         "ms": k2[True]["ms"], "plain_ms": k2[True]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

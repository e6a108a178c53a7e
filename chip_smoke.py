#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (open_ludwig_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. device: CUDA must be available; prints the card, `nvidia-smi` name and
     power limit, and the toolchain;
  2. build: K1 (csrc/stream_collide.cu), K2 (csrc/bouzidi.cu) and K3
     (csrc/fused_pair.cu) with nvcc for sm_90a into build/kernels/, one
     nvcc per source, all at once; prints registers, spills and K3's shared
     memory and occupancy;
  3. K1 against its plain PyTorch version on the card, on the bench case's
     levels (wall model, sponge blend, inlet noise 0.02, every face type)
     and on a 10.8M-cell single-level sweep shape, float32 and bf16;
  4. K2 against its plain version on the bench case's own Bouzidi box;
  4b. K3 (+ K2) against the plain pair and against K1 -> K2 -> K1 (+ K2),
     float32 and bf16, on the bench's finest level (six interface faces,
     distinct ghost planes per sub-step, box 29x28x28) and on the 10.8M-cell
     single level (inlet, outlet, mirrors, inlet noise, wall model, sponge
     ramp, the sphere's box); times K3, the unfused kernels and the plain pair;
  4c. fused against unfused on the card: 4 coarse steps of the bench case
     through make_batch_runner_dense(fuse2=True) and (fuse2=False) from one
     random state, float32 and bf16, per level;
  5. the slice: `open_ludwig_torch.runner.solve_case` on the bench case
     (sphere Re~1M, N=25, 3 levels + wake, wall model, Bouzidi, bf16
     g-storage) for 400 coarse steps, fused by default: finite CSVs,
     rho_min in (0.5, 1.5), launch counts per coarse step K1 = 3, K3 = 2,
     K2 = 2, and MLUPS-su / MLUPS-ref from CUDA events over the post-warm-up
     intervals;
  6. the single-level path: `solve_case` on the 10.8M-cell case (bf16,
     75 coarse steps in batches of 25, so each batch takes one plain step
     and 12 pairs): finite CSVs, rho_min in (0.5, 1.5), per batch of n
     steps K1 = n % 2, K3 = n // 2, K2 = n // 2 + n % 2, and MLUPS from CUDA
     events over the batches after the first; then one 50-step batch of the
     runner fused and unfused, in turns, timed with CUDA events.
Prints one JSON line of kernel results, then, as its last line,
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.
"""

import csv
import dataclasses
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
    from open_ludwig_torch import lattice as lat
    from open_ludwig_torch.ops import build, cuda_step, storage
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver_dense import (
        build_patch_statics,
        make_batch_runner_dense,
    )

    def check_run_outputs(res, cfg) -> None:
        """Finite CSV rows and a stable final state of a solve_case run."""
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

    def random_states(levels, precision, seed):
        """Level states perturbed around rest, made from a numpy seed."""
        rng = np.random.default_rng(seed)
        states = []
        for p in levels:
            sh = tuple(p.interior)
            f = (lat.W[:, None, None, None]
                 * (1 + 0.03 * rng.standard_normal((27,) + sh))).astype(np.float32)
            states.append({
                "f": storage.encode_f(torch.as_tensor(f, device=dev), precision),
                "rho": torch.as_tensor((1 + 0.01 * rng.standard_normal(sh))
                                       .astype(np.float32), device=dev),
                "vel": torch.as_tensor((0.02 * rng.standard_normal((3,) + sh))
                                       .astype(np.float32), device=dev),
            })
        return states

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    t_run = time.time()

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
    knames = ("stream_collide", "bouzidi", "fused_pair")
    t0 = time.time()
    for kname, b in zip(knames, build.load_all(knames)):
        res = [ln.strip() for ln in b.ptxas_log.splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"[2 build] {kname}: {b.seconds:.1f} s -> {b.path}", flush=True)
        for ln in res:
            print(f"[2 build]   {ln}")
    print(f"[2 build] all kernels in {time.time() - t0:.1f} s (parallel nvcc)")
    for bf16 in (False, True):
        a = cuda_step.fused_pair_attrs(bf16)
        print(f"[2 build] fused_pair {'bf16' if bf16 else 'f32 '}: "
              f"{a['registers']} registers, {a['local_bytes']} B local, "
              f"{a['smem_bytes']} B shared per block, {a['blocks_per_sm']} "
              "block(s) per SM", flush=True)
        require(a["blocks_per_sm"] >= 1, ("fused_pair occupancy", bf16, a))

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

        # ---- 4b. K3 (+ K2) against the plain pair and the unfused kernels ----
        k3 = {}
        k3_cases = (
            ("L3", levels[2], checks.with_sponge_ramp(statics[2]), 20, 3),
            ("sweep", sweep[0], checks.with_sponge_ramp(sweep_static), 5, 1),
        )
        for label, patch, static, reps, plain_reps in k3_cases:
            for bf16 in (False, True):
                r = checks.check_fused_pair(patch, static, static["bouzidi"], bf16,
                                            seed=23, kw=kw, device=dev, reps=reps,
                                            plain_reps=plain_reps)
                k3[(label, bf16)] = r
                u = r["unfused"]
                print(f"[4b K3] {label} {patch.interior} box "
                      f"{tuple(static['bouzidi']['dim'])} {'bf16' if bf16 else 'f32 '}"
                      f" | vs plain: err f/rho/vel {r['err']['f']:.2e}/"
                      f"{r['err']['rho']:.2e}/{r['err']['vel']:.2e} (tol "
                      f"{r['tol']:.0e}), {100 * r['diff_frac']:.3f}% stored f "
                      f"differ | vs K1->K2->K1: max {u['max_abs_err']:.2e}, "
                      f"{100 * u['diff_frac']:.3f}% differ | K3 {r['ms']:.4f} ms, "
                      f"K1->K2->K1 {r['unfused_ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.3f} ms | card: {smi}", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"],
                        ("K3 vs plain", label, bf16, r["err"]))
                require(checks.within_k3_tol(u, bf16),
                        ("K3 vs unfused kernels", label, bf16, u))
        del sweep, sweep_static
        torch.cuda.empty_cache()

        # ---- 4c. fused against unfused on the card: 4 coarse steps ----
        for precision in ("float32", "bfloat16"):
            bf16 = precision == "bfloat16"
            cfg_p = dataclasses.replace(cfg, precision=precision)
            out = []
            for fuse2 in (True, False):
                run = make_batch_runner_dense(cfg_p, params, levels, statics,
                                              fuse2=fuse2)
                out.append(run(random_states(levels, precision, 29), 1, 4))
            torch.cuda.synchronize()
            for li, (a, b) in enumerate(zip(*out)):
                d = checks.state_diff(a["f"], a["rho"], a["vel"],
                                      b["f"], b["rho"], b["vel"])
                print(f"[4c fused vs unfused] {precision} L{li + 1}: max "
                      f"{d['max_abs_err']:.2e} (f {d['err']['f']:.2e}), "
                      f"{100 * d['diff_frac']:.3f}% stored f differ", flush=True)
                require(checks.within_k3_tol(d, bf16),
                        ("fused vs unfused", precision, li, d))
            del out
        torch.cuda.empty_cache()

        # ---- 5. the slice through the runner ----
        cuda_step.reset_launches()
        res = solve_case(cfg, device="cuda")
        launches = dict(cuda_step.LAUNCHES)
        steps = cfg.steps
        print(f"[5 slice] launches {launches} over {steps} coarse steps", flush=True)
        require(launches == {"stream_collide": 3 * steps, "fused_pair": 2 * steps,
                             "bouzidi": 2 * steps}, ("slice launches", launches))
        check_run_outputs(res, cfg)
        win = res.windows[1:]  # the first interval carries the warm-up
        n_steps = sum(b - a + 1 for a, b, _ in win)
        sec = sum(ms for _, _, ms in win) / 1e3
        su = res.updates_per_coarse * n_steps / sec / 1e6
        ref = res.total_cells * n_steps / sec / 1e6
        print(f"[5 slice] {res.total_cells / 1e6:.3f}M cells, "
              f"{res.updates_per_coarse / 1e6:.3f}M site updates per coarse step | "
              f"{n_steps} steps after warm-up in {sec:.3f} s (CUDA events) -> "
              f"{su:.1f} MLUPS-su, {ref:.1f} MLUPS-ref | {sec / n_steps * 1e3:.3f} "
              f"ms/coarse step | rho_min {res.final_stats.rho_min:.4f} | Cd "
              f"{res.final_forces.Cd:.4f} | card: {smi}", flush=True)

        # ---- 6. the single-level path: pairs of coarse steps ----
        t0 = time.time()
        cfg1, _, params1, levels1 = checks.bench_case(
            os.path.join(tmp, "single"), surface_resolution=25, num_levels=1,
            steps=75, diag_freq=25)
        print(f"[6 single] case written in {time.time() - t0:.1f} s", flush=True)
        cuda_step.reset_launches()
        res1 = solve_case(cfg1, device="cuda")
        got = dict(cuda_step.LAUNCHES)
        sizes = [b - a + 1 for a, b, _ in res1.windows]
        want = {"stream_collide": sum(n % 2 for n in sizes),
                "fused_pair": sum(n // 2 for n in sizes),
                "bouzidi": sum(n // 2 + n % 2 for n in sizes)}
        print(f"[6 single] batches {sizes} | launches {got}", flush=True)
        require(sum(sizes) == cfg1.steps and got == want,
                ("single-level launches", sizes, got, want))
        check_run_outputs(res1, cfg1)
        win = res1.windows[1:]
        n_steps = sum(b - a + 1 for a, b, _ in win)
        sec = sum(ms for _, _, ms in win) / 1e3
        mlups = res1.total_cells * n_steps / sec / 1e6
        print(f"[6 single] {res1.total_cells / 1e6:.3f}M cells | {n_steps} steps "
              f"after the first batch in {sec:.3f} s (CUDA events) -> {mlups:.1f} "
              f"MLUPS (su = ref on one level) | {sec / n_steps * 1e3:.3f} "
              f"ms/coarse step | rho_min {res1.final_stats.rho_min:.4f} | Cd "
              f"{res1.final_forces.Cd:.4f} | card: {smi}", flush=True)
        # the same batch fused and unfused, in turns, from one state
        statics1 = build_patch_statics(cfg1, levels1, dev)
        state1 = random_states(levels1, cfg1.precision, 31)
        per_step = {True: [], False: []}
        for fuse2 in (True, False, False, True):
            run = make_batch_runner_dense(cfg1, params1, levels1, statics1,
                                          fuse2=fuse2)
            per_step[fuse2].append(
                checks.time_cuda(lambda: run(state1, 1, 50), reps=1) / 50)
        print("[6 single] 50-step batch, per coarse step (fused, unfused, "
              "unfused, fused): " + ", ".join(
                  f"{ms:.4f} ms" for ms in (per_step[True][0], *per_step[False],
                                            per_step[True][1]))
              + f" -> fused {res1.total_cells / min(per_step[True]) / 1e3:.0f}, "
              f"unfused {res1.total_cells / min(per_step[False]) / 1e3:.0f} "
              f"MLUPS | card: {smi}", flush=True)
        del state1, statics1

    print(f"[done] {time.time() - t_run:.1f} s", flush=True)
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
        {"name": "fused_pair", "route": "cuda",
         "source": "open_ludwig_torch/csrc/fused_pair.cu",
         "replaces": "open_ludwig_tpu/ops/pallas_step.py:961",
         "launches": launches["fused_pair"],
         "max_abs_err": max(r["max_abs_err"] for (lab, bf), r in k3.items() if bf),
         "ms": k3[("L3", True)]["ms"], "plain_ms": k3[("L3", True)]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

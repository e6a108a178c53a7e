"""Case runner for the PyTorch/CUDA port.

    python -m open_ludwig_torch.runner <case_dir> [<case_dir> ...] [--device cuda|cpu]

Port of `open_ludwig_tpu/runner.py:solve_case` for `layout: patch` on one
device: build the nested patches and statics, step the multi-level
schedule between diagnostics boundaries with no host sync (temporal
blocking on, as in the JAX runner: the finest level's sub-step pairs, or a
single-level case's coarse-step pairs, run as one fused kernel), and at each
boundary log flow statistics, MLUPS-ref and Cd/Cl, append
convergence.csv / forces.csv (the JAX runner's schemas) and check
stability.  The default device is `cuda`, which raises when CUDA is
missing; `cpu` runs the plain PyTorch path.

Not ported yet, and refused with the ROADMAP.md Queue 1 item that ports
it: several devices, the blocks layout, momentum-exchange forces,
checkpoints.  VTK output is not written yet (one log line says so).
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import CaseConfig, load_case_config
from .core.patch import build_patches
from .diagnostics import FlowStats, check_stability, compute_flow_stats
from .geometry import load_mesh
from .io.csv_out import (
    append_convergence,
    append_forces,
    print_force_summary,
    walltime_str,
    write_convergence_header,
    write_forces_header,
)
from .ops.forces import ForceResult, compute_aerodynamics, make_force_context_dense
from .scaling import compute_domain_params
from .solver_dense import (
    build_patch_statics,
    hbm_report_patches,
    init_patch_state,
    kernel_log_lines,
    make_batch_runner_dense,
)

log = logging.getLogger("open_ludwig_torch")


@dataclass
class SolveResult:
    total_cells: int
    updates_per_coarse: int  # site updates per coarse step (cells x 2^(l-1))
    steps: int
    wall_time: float
    mlups: float  # MLUPS-ref end to end (cells x coarse steps / wall)
    final_stats: Optional[FlowStats]
    final_forces: Optional[ForceResult]
    # per diagnostics interval on CUDA: (first step, last step, device ms
    # between CUDA events around the interval's batch of coarse steps)
    windows: List[Tuple[int, int, float]] = field(default_factory=list)


def check_supported(cfg: CaseConfig) -> None:
    """Raise on configurations that need parts not ported yet."""
    if cfg.layout != "patch":
        raise NotImplementedError(
            f"layout: {cfg.layout} is not ported (ROADMAP.md Queue 1: "
            "'Blocks layout'); use layout: patch")
    if cfg.devices > 1:
        raise NotImplementedError(
            f"devices: {cfg.devices} is not ported (ROADMAP.md Queue 1: "
            "'Multi-GPU'); the port runs on one device")
    if cfg.forces_enabled and cfg.force_method != "stress":
        raise NotImplementedError(
            f"forces.method: {cfg.force_method} is not ported (ROADMAP.md "
            "Queue 1: 'MEM forces, VTK, checkpoint'); use stress")
    if cfg.checkpoint_freq > 0 or cfg.checkpoint_resume:
        raise NotImplementedError(
            "checkpoints are not ported (ROADMAP.md Queue 1: 'MEM forces, "
            "VTK, checkpoint'); set checkpoint.freq: 0 and resume: false")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available; "
                           "pass --device cpu to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _ramp_host(t: int, cfg: CaseConfig) -> float:
    if t <= cfg.ramp_steps:
        return float(cfg.u_lattice * 0.5 * (1 - np.cos(np.pi * t / cfg.ramp_steps)))
    return float(cfg.u_lattice)


def solve_case(cfg: CaseConfig, device="cuda") -> SolveResult:
    check_supported(cfg)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t_start = time.time()
    log.info("=" * 70)
    log.info("  PyTorch LBM | D3Q27 | WALE LES | device %s | case: %s",
             torch.cuda.get_device_name(dev) if cuda else "cpu",
             os.path.basename(cfg.case_dir))
    log.info("=" * 70)

    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, levels, dev)
    states = [init_patch_state(p, cfg.precision, dev) for p in levels]
    total_cells = sum(p.n_cells for p in levels)
    updates = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)
    log.info(hbm_report_patches(levels, statics, cfg.precision, dev))
    for line in kernel_log_lines(levels, statics, cfg.precision, dev):
        log.info(line)
    log.info("[Info] Re = %.0f, levels = %d, tau = %s", params.re_number,
             params.num_levels, ", ".join(f"{t:.6f}" for t in params.tau_levels))
    log.info("[Info] total cells: %.2f M (layout=patch) | %.2f M site updates "
             "per coarse step | host setup %.1f s", total_cells / 1e6,
             updates / 1e6, time.time() - t_start)
    log.info("[Output] VTK export is not ported yet (ROADMAP.md Queue 1: "
             "'MEM forces, VTK, checkpoint'); output_freq=%d writes nothing",
             cfg.output_freq)

    out_dir = cfg.output_path
    if os.path.isdir(out_dir):
        for f in os.listdir(out_dir):
            p = os.path.join(out_dir, f)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    os.makedirs(out_dir, exist_ok=True)
    conv_csv = os.path.join(out_dir, "convergence.csv")
    force_csv = os.path.join(out_dir, "forces.csv")
    write_convergence_header(conv_csv)
    force_ctx = None
    if cfg.forces_enabled:
        write_forces_header(force_csv)
        force_ctx = make_force_context_dense(
            mesh, levels[-1], params, extrapolate=cfg.force_extrapolate,
            device=dev)

    run = make_batch_runner_dense(cfg, params, levels, statics)
    states = run.seed_slabs(states)
    log.info("[Run] steps=%d ramp=%d diag=%d", cfg.steps, cfg.ramp_steps,
             cfg.diag_freq)
    log.info("%8s | %12s | %10s | %7s | %7s | %7s | %8s | %8s", "Step",
             "Walltime", "Time[s]", "U_lat", "rho_min", "MLUPS-ref", "Cd", "Cl")

    fof = cfg.effective_force_output_freq if cfg.forces_enabled else 0
    freqs = [cfg.diag_freq] + ([fof] if fof > 0 else [])
    events = []
    t = 1
    last_diag_time = time.time()
    last_forces = None
    final_stats = None
    while t <= cfg.steps:
        batch_end = min(min(((t - 1) // f + 1) * f for f in freqs), cfg.steps)
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        states = run(states, t, batch_end - t + 1)
        if cuda:
            ev[1].record()
            events.append((t, batch_end, ev))
        t_done = batch_end

        if force_ctx is not None and fof > 0 and t_done % fof == 0:
            last_forces = compute_aerodynamics(states[-1], force_ctx)
            append_forces(force_csv, t_done, t_done * params.time_scale,
                          last_forces, _ramp_host(t_done, cfg))

        if t_done % cfg.diag_freq == 0 or t_done == cfg.steps:
            if cuda:
                torch.cuda.synchronize(dev)
            now = time.time()
            # MLUPS-ref: cells x coarse steps (reference: main.jl:188-190)
            mlups = total_cells * cfg.diag_freq / max(now - last_diag_time, 1e-9) / 1e6
            last_diag_time = now
            stats = compute_flow_stats(states[0], statics[0]["obstacle"])
            final_stats = stats
            u_curr = _ramp_host(t_done, cfg)
            cd_str = cl_str = "N/A"
            if force_ctx is not None:
                if last_forces is None or t_done % fof != 0:
                    last_forces = compute_aerodynamics(states[-1], force_ctx)
                cd_str, cl_str = f"{last_forces.Cd:.4f}", f"{last_forces.Cl:.4f}"
            wall = walltime_str(t_start)
            log.info("%8d | %12s | %10.4f | %.4f | %.4f | %7.1f | %8s | %8s",
                     t_done, wall, t_done * params.time_scale, u_curr,
                     stats.rho_min, mlups, cd_str, cl_str)
            append_convergence(conv_csv, t_done, wall, t_done * params.time_scale,
                               u_curr, stats.rho_min, mlups, cd_str, cl_str)
            if cfg.stability_check:
                warns = check_stability(stats, t_done)
                for w in warns:
                    log.warning("[Stability] step %d: %s", t_done, w)
                diverged = not np.isfinite(stats.rho_min) or stats.rho_min < 0.5 \
                    or stats.rho_max > 1.5 or not np.isfinite(stats.v_max)
                if warns and cfg.stability_action == "abort" and diverged:
                    raise RuntimeError(
                        f"simulation diverged at step {t_done}: {warns[0]}")
        t = t_done + 1

    if cuda:
        torch.cuda.synchronize(dev)
    windows = [(a, b, float(ev[0].elapsed_time(ev[1]))) for a, b, ev in events]
    wall_total = time.time() - t_start
    # MLUPS-ref = total cells x COARSE steps / wall (the reference's
    # convention, main.jl:188-190); MLUPS-su counts site updates
    # (cells x 2^(level-1)) and is what the chip smoke reports beside it
    mlups_total = total_cells * cfg.steps / max(wall_total, 1e-9) / 1e6
    log.info("=" * 70)
    log.info("  COMPLETE | wall %.1f s | %.1f MLUPS-ref end-to-end (cells x "
             "coarse-steps, set-up included)", wall_total, mlups_total)
    if last_forces is not None:
        log.info("\n%s", print_force_summary(
            last_forces, params.rho_physical, params.u_physical,
            params.reference_area, params.reference_chord))
        with open(force_csv) as fh:
            rows = list(csv.DictReader(fh))
        cut = cfg.steps - max(cfg.steps // 3, 1)
        cds = [float(r["Cd"]) for r in rows if int(r["Step"]) >= cut]
        cls_ = [float(r["Cl"]) for r in rows if int(r["Step"]) >= cut]
        if cds:
            log.info("  time-averaged (last third): Cd = %.4f +- %.4f | "
                     "Cl = %.4f +- %.4f", float(np.mean(cds)), float(np.std(cds)),
                     float(np.mean(cls_)), float(np.std(cls_)))
    return SolveResult(
        total_cells=total_cells, updates_per_coarse=updates, steps=cfg.steps,
        wall_time=wall_total, mlups=mlups_total, final_stats=final_stats,
        final_forces=last_forces, windows=windows,
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    ap = argparse.ArgumentParser(prog="python -m open_ludwig_torch.runner")
    ap.add_argument("case_dirs", nargs="+", help="case directories (config.yaml + STL)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for case_dir in args.case_dirs:
        solve_case(load_case_config(case_dir), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

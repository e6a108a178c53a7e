"""Case runner for the PyTorch/CUDA port.

    python -m open_ludwig_torch.runner <case_dir> [<case_dir> ...] [--device cuda|cpu]
    python -m open_ludwig_torch.runner --plan <case_dir> [...] [--device cuda|cpu]
    python -m open_ludwig_torch.runner --batch <cases_to_run.yaml> [<cases_root>] [--device ...]

Port of `open_ludwig_tpu/runner.py` (`solve_case`, `run_all_cases`,
`plan_case`, the CLI) for both layouts.  `layout: patch` (the default):
build the nested patches and statics, step the multi-level schedule
between event boundaries with no host sync (temporal blocking on, as in
the JAX runner: the finest level's sub-step pairs, or a single-level
case's coarse-step pairs, run as one fused kernel).  `layout: blocks`:
the sparse 8^3-block levels (`domain.builder`, `core.state`) stepped by
`solver.make_batch_runner` in float32 plain PyTorch, as the JAX package
runs that layout with no kernel of its own: another `precision` logs a
warning and runs float32, `forces.method: momentum_exchange` logs a
warning and falls back to stress mapping, and `devices` builds no mesh.
At each event boundary:
  - forces (stress mapping, or momentum exchange over the finest level's
    fluid/solid links with the stress maps kept for the surface file)
    into forces.csv at the force cadence;
  - flow statistics, MLUPS-ref and Cd/Cl into convergence.csv and the
    stability check (`stability_action: abort` saves a checkpoint, then
    raises) at the diagnostics cadence;
  - `flow_{step:06d}.vtu` and, with forces on, `surface_{step:06d}.vtu`
    at `output_freq`;
  - a checkpoint (npz format 1, written on a background thread) at
    `checkpoint.freq`.
`checkpoint.resume` continues from the latest checkpoint of the output
directory, dropping CSV rows past its step.  `async_depth` caps the
coarse steps per call of the batch runner within a batch (0: the whole
batch), with no host sync between the calls (reference:
gpu.async_depth, main.jl:166-180); the states do not depend on it.
Both layouts run a batch as one program by default (`graphs=True`): each
coarse step is the replay of a CUDA graph on a card (`graphs.GraphSet`,
`solver_dense.make_batch_runner_dense`, `solver.make_batch_runner`), with
its inlet speed and seeds read from a step record on the device; the CPU
runs the same steps eagerly.  The kernel log names the graphs, their
captured launches and their memory pool after the first batch.
`OPEN_LUDWIG_PROFILE=<dir>` writes a torch.profiler trace of the second
batch; it carries the port's spans as "olt.<name>" ranges on the host's
timeline (`spans`: the runner's calls and units, the events, their
read-backs), the parents of the launches they enclose.  At the end of a
case the log gives the case's spans (calls, host seconds) and counters
(`sync.forces`, `sync.stats`: blocking copies to the host), at INFO.
`--batch` runs the listed cases, a failing case logged and
skipped; `--plan` prints the set-up and device-memory report with the
card's capacity.  The default device is `cuda`, which raises when CUDA is
missing; `cpu` runs the plain PyTorch path.

`devices: n` (n > 1) cuts every level of the patch layout along x over
n devices (`parallel.patch_shard`, the JAX package's x-slab mesh): the
first n visible cards with `--device cuda` (fewer raise), n CPU slabs with
`--device cpu`; `solve_case(cfg, x_mesh=...)` takes a mesh built by the
caller instead (a virtual mesh of n slabs on one card,
`XMesh([torch.device("cuda", 0)] * n)`).  The run is then unfused.  Its
events read a level in the global layout, gathered from the slabs where
the event needs it (`global_level`: forces and diagnostics on the first
device, checkpoints and flow files on the host), so forces, statistics
and files are one device's, and a sharded run resumes from a
single-device checkpoint and the reverse.  `--plan` reports the patch
layout, whatever the case's layout, as the JAX package's does.
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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt
from . import memory, spans
from .config import CaseConfig, load_batch_list, load_case_config
from .core.patch import build_patches
from .core.state import build_all, hbm_report
from .diagnostics import FlowStats, check_stability, compute_flow_stats
from .domain.builder import setup_case
from .geometry import load_mesh
from .io.csv_out import (
    append_convergence,
    append_forces,
    print_force_summary,
    walltime_str,
    write_convergence_header,
    write_forces_header,
)
from .io.vtk import export_flow_vtu, export_flow_vtu_patches, export_surface_vtu
from .ops import storage
from .parallel.patch_shard import (
    XMesh,
    gather_states,
    init_states_sharded,
    make_x_mesh,
    shard_states,
)
from .ops.forces import (
    ForceResult,
    compute_aerodynamics,
    compute_aerodynamics_mem,
    make_force_context,
    make_force_context_dense,
    make_mem_context,
)
from .scaling import compute_domain_params
from .solver import make_batch_runner
from .solver_dense import (
    build_patch_statics,
    hbm_report_patches,
    hbm_total_patches,
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
    # per batch on CUDA: (first step, last step, device ms between CUDA
    # events around the batch of coarse steps)
    windows: List[Tuple[int, int, float]] = field(default_factory=list)
    resume_step: int = 0
    # per file written: (kind "flow" / "surface" / "checkpoint", step, path,
    # host seconds; a checkpoint's are its fetch, its write is async)
    outputs: List[Tuple[str, int, str, float]] = field(default_factory=list)
    # the batch runner's graphs (`graphs.GraphSet.report`), or why none
    graph_report: str = ""


def check_supported(cfg: CaseConfig) -> None:
    """Raise on configurations the runner does not know."""
    if cfg.layout not in ("patch", "blocks"):
        raise ValueError(f"layout: {cfg.layout} is unknown; use patch or blocks")


def resolve_mesh(cfg: CaseConfig, dev: torch.device,
                 x_mesh: Optional[XMesh]) -> Optional[XMesh]:
    """The run's x mesh: the caller's, else `cfg.devices` slabs on `dev`'s
    kind (`make_x_mesh`, which raises when fewer cards are visible), else
    None (one device).  A mesh of one device is no mesh.  The blocks
    layout runs on one device: `devices` builds no mesh for it (the JAX
    runner's mesh branch is the patch layout's), and a mesh given for it
    raises."""
    if cfg.layout == "blocks":
        if x_mesh is not None and x_mesh.size > 1:
            raise ValueError("an x mesh needs layout: patch")
        return None
    if x_mesh is None and cfg.devices > 1:
        x_mesh = make_x_mesh(cfg.devices, dev)
    if x_mesh is not None and x_mesh.size == 1:
        return None
    return x_mesh


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


def _truncate_csv_after_step(path: str, resume_step: int) -> None:
    """Keep only the header and rows with Step <= resume_step."""
    if not os.path.isfile(path):
        return
    with open(path) as f:
        lines = f.readlines()
    if not lines:
        return
    kept = [lines[0]]
    for ln in lines[1:]:
        try:
            if int(ln.split(",", 1)[0]) <= resume_step:
                kept.append(ln)
        except ValueError:
            kept.append(ln)
    if len(kept) != len(lines):
        with open(path, "w") as f:
            f.writelines(kept)
        log.info("[Checkpoint] truncated %s to step %d (%d rows dropped)",
                 os.path.basename(path), resume_step, len(lines) - len(kept))


def _check_resumed(states: List[Dict], levels, precision: str, path: str) -> None:
    """The loaded states must be the case's levels, in its storage type (a
    blocks level: (27, nb, 512) float32)."""
    want_dt = storage.f_dtype(precision)
    if len(states) != len(levels):
        raise ValueError(f"{path}: {len(states)} levels, the case has {len(levels)}")
    for st, p in zip(states, levels):
        sh = ((p.n_blocks, 512) if hasattr(p, "block_ptr") else tuple(p.interior))
        if (tuple(st["f"].shape) != (27,) + sh or tuple(st["rho"].shape) != sh
                or tuple(st["vel"].shape) != (3,) + sh or st["f"].dtype != want_dt):
            raise ValueError(
                f"{path}: level {p.level_id} holds f {tuple(st['f'].shape)} "
                f"{st['f'].dtype}, the case needs {(27,) + sh} {want_dt} (a JAX "
                "package checkpoint needs convert.checkpoint_from_jax)")


def solve_case(cfg: CaseConfig, device="cuda",
               x_mesh: Optional[XMesh] = None, graphs: bool = True) -> SolveResult:
    """Run the case on `device`, or over the x slabs of `x_mesh` (built
    from `cfg.devices` when it is above 1 and no mesh is given).  With
    `graphs` (the default) both layouts' batch runners run each coarse
    step as one program, replayed from a CUDA graph on a card (eagerly on
    the CPU); `graphs=False` is the loop that launches every kernel from
    the host, bit-equal to it.  Each patch level's kernel is the card's
    rule's (`ops.engine.card_engines`: the card's memory less its reserve,
    `memory.card_capacity`; no limit on the CPU), each sub-step one launch
    (the runner's default, unfused)."""
    check_supported(cfg)
    spans_at = spans.snapshot()
    dev = resolve_device(device)
    x_mesh = resolve_mesh(cfg, dev, x_mesh)
    if x_mesh is not None:
        dev = x_mesh.devices[0]
        log.info("[Mesh] %d x slabs on %s", x_mesh.size,
                 ", ".join(map(str, x_mesh.devices)))
    cuda = dev.type == "cuda"
    t_start = time.time()
    log.info("=" * 70)
    log.info("  PyTorch LBM | D3Q27 | WALE LES | device %s | case: %s",
             torch.cuda.get_device_name(dev) if cuda else "cpu",
             os.path.basename(cfg.case_dir))
    log.info("=" * 70)

    blocks = cfg.layout == "blocks"
    fresh = None  # the blocks layout's rest states, built with its statics
    if blocks:
        if storage.normalize_precision(cfg.precision) != storage.STORE_F32:
            log.warning("[Config] precision=%s is only supported on layout=patch; "
                        "the blocks layout runs float32", cfg.precision)
        # float32 from here on: the states, a resumed checkpoint's check
        cfg = cfg.with_overrides(precision=storage.STORE_F32)
        mesh, params, levels = setup_case(cfg)
        fresh, statics = build_all(cfg, params, levels, dev)
    else:
        mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
        params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
        levels = build_patches(cfg, mesh, params)
        statics = build_patch_statics(cfg, levels, dev, x_mesh=x_mesh)
    total_cells = sum(p.n_cells for p in levels)
    updates = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)

    out_dir = cfg.output_path
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    resume_step = 0
    latest = ckpt.latest_checkpoint(ckpt_dir) if cfg.checkpoint_resume else None
    if latest:
        # a sharded run loads on the host and cuts the global arrays
        resume_step, states = ckpt.load_checkpoint(
            latest, None if blocks else cfg.precision,
            "cpu" if x_mesh is not None else dev)
        _check_resumed(states, levels, cfg.precision, latest)
        if x_mesh is not None:
            states = shard_states(states, x_mesh)
        log.info("[Checkpoint] resumed from %s at step %d", latest, resume_step)
    else:
        states = (fresh if blocks else
                  init_states_sharded(levels, cfg.precision, x_mesh)
                  if x_mesh is not None else
                  [init_patch_state(p, cfg.precision, dev) for p in levels])
        if os.path.isdir(out_dir):
            for f in os.listdir(out_dir):
                p = os.path.join(out_dir, f)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        os.makedirs(out_dir, exist_ok=True)
    fresh = None
    if blocks:
        log.info(hbm_report(levels, statics))
        log.info("[Engine] blocks layout: float32 plain PyTorch step on every "
                 "level (the JAX package's blocks layout has no kernel)")
    else:
        log.info(hbm_report_patches(levels, statics, cfg.precision, dev,
                                    x_mesh=x_mesh))
        for line in kernel_log_lines(levels, statics, cfg.precision, dev,
                                     x_mesh=x_mesh):
            log.info(line)
    log.info("[Info] Re = %.0f, levels = %d, tau = %s", params.re_number,
             params.num_levels, ", ".join(f"{t:.6f}" for t in params.tau_levels))
    log.info("[Info] total cells: %.2f M (layout=%s) | %.2f M site updates "
             "per coarse step | host setup %.1f s", total_cells / 1e6, cfg.layout,
             updates / 1e6, time.time() - t_start)

    conv_csv = os.path.join(out_dir, "convergence.csv")
    force_csv = os.path.join(out_dir, "forces.csv")
    if resume_step == 0:
        write_convergence_header(conv_csv)
        if cfg.forces_enabled:
            write_forces_header(force_csv)
    else:
        # drop rows past the resume step so a re-run after a late crash
        # doesn't duplicate Step entries in the histories
        _truncate_csv_after_step(conv_csv, resume_step)
        _truncate_csv_after_step(force_csv, resume_step)

    force_ctx = mem_ctx = None
    if cfg.forces_enabled:
        force_ctx = (make_force_context if blocks else make_force_context_dense)(
            mesh, levels[-1], params, extrapolate=cfg.force_extrapolate,
            device=dev)
        if cfg.force_method == "momentum_exchange":
            mem_ctx = None if blocks else make_mem_context(
                levels[-1], params, mesh,
                g_storage=storage.f_dtype(cfg.precision) == torch.bfloat16,
                device=dev)
            if mem_ctx is None:
                log.warning(
                    "[Forces] method=momentum_exchange needs obstacle cells on "
                    "the finest level of the patch layout; falling back to "
                    "stress mapping")
            else:
                log.info("[Forces] momentum-exchange integration over %d "
                         "fluid/solid interface links", mem_ctx.n_links)

    if blocks:
        run = make_batch_runner(cfg, params, statics, graphs=graphs)
    else:
        run = make_batch_runner_dense(cfg, params, levels, statics, x_mesh=x_mesh,
                                      graphs=graphs)
        states = run.seed_slabs(states)
    if getattr(run, "graph_note", None):
        log.info(run.graph_note)
    elif run.graph_set is None:
        log.info("[Graph] off: every launch issued from the host (graphs=False)")
    elif cuda:
        log.info("[Graph] each coarse step (pair, on a single level) one CUDA "
                 "graph replay; %s", "async_depth %d coarse steps per call"
                 % cfg.async_depth if cfg.async_depth > 0 else "one call per batch")
    gathered: Dict = {}  # (level, device) -> the level gathered since the batch

    def global_level(lvl: int, device=dev) -> Dict:
        """states[lvl] in the global layout: a sharded run's slabs gathered
        onto `device`, once per batch.  The events below read the states
        only through it, so none of them meets the slabs."""
        if x_mesh is None:
            return states[lvl]
        key = (lvl % len(levels), str(device))
        if key not in gathered:
            gathered[key] = gather_states([states[key[0]]], device)[0]
        return gathered[key]

    def host_states() -> List[Dict]:
        """Every level in the global layout, for a checkpoint or flow file
        (a sharded run's gathered onto the host, where they are written)."""
        return [global_level(lvl, "cpu" if x_mesh is not None else dev)
                for lvl in range(len(levels))]

    def _forces() -> ForceResult:
        """Integrated aerodynamics at the configured method.  The stress
        mapping always runs (its per-triangle pressure/shear maps feed the
        surface VTK); momentum exchange replaces the integrals and
        coefficients (the reference's dead method, src/forces/global.jl:
        15-148, live here: VALIDATION.md)."""
        base = compute_aerodynamics(global_level(-1), force_ctx)
        if mem_ctx is None:
            return base
        return compute_aerodynamics_mem(global_level(-1), mem_ctx, base=base)

    obstacle0 = (statics[0]["obstacle"] if x_mesh is None else
                 torch.as_tensor(levels[0].obstacle, dtype=torch.bool, device=dev))
    cards = ([dev] if x_mesh is None else
             list(dict.fromkeys(x_mesh.devices))) if cuda else []

    def sync() -> None:
        for d in cards:
            torch.cuda.synchronize(d)

    log.info("[Run] steps=%d ramp=%d diag=%d vtk=%d checkpoint=%d%s", cfg.steps,
             cfg.ramp_steps, cfg.diag_freq, cfg.output_freq, cfg.checkpoint_freq,
             f" (resumed at {resume_step})" if resume_step else "")
    log.info("%8s | %12s | %10s | %7s | %7s | %7s | %8s | %8s", "Step",
             "Walltime", "Time[s]", "U_lat", "rho_min", "MLUPS-ref", "Cd", "Cl")

    # event boundaries: diagnostics, VTK, forces, checkpoint
    fof = cfg.effective_force_output_freq if cfg.forces_enabled else 0
    freqs = [f for f in (cfg.diag_freq, cfg.output_freq, fof, cfg.checkpoint_freq)
             if f > 0]
    profile_dir = os.environ.get("OPEN_LUDWIG_PROFILE")
    prof = None
    events = []
    outputs = []
    t = resume_step + 1
    graph_logged = False
    last_diag_time = time.time()
    last_forces = None
    final_stats = None
    while t <= cfg.steps:
        # one torch.profiler trace of the second batch (after the first
        # batch's warm-up), the reference's jax.profiler trace
        if profile_dir and prof is None and t > cfg.diag_freq:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.start()
        batch_end = min(min(((t - 1) // f + 1) * f for f in freqs), cfg.steps)
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        # the whole batch is queued without a host sync, in calls of at most
        # async_depth coarse steps (0: one call)
        depth = cfg.async_depth if cfg.async_depth > 0 else batch_end - t + 1
        for t_sub in range(t, batch_end + 1, depth):
            states = run(states, t_sub, min(depth, batch_end - t_sub + 1))
        gathered.clear()
        if cuda:
            ev[1].record()
            events.append((t, batch_end, ev))
        t_done = batch_end
        if run.graph_set is not None and cuda and not graph_logged and \
                run.graph_set.graphs:
            graph_logged = True
            log.info(run.graph_set.report())
            if not blocks:
                est = hbm_total_patches(levels, statics, cfg.precision, dev) \
                    if x_mesh is None else None
                log.info("[Graph] device memory: %s + the graphs' pool %.1f MB; "
                         "%.3f GB allocated", "estimate %.3f GB" % (est / 1e9)
                         if est is not None else "the per-slab estimate above",
                         run.graph_set.pool_bytes / 1e6,
                         torch.cuda.memory_allocated(dev) / 1e9)

        # force-CSV cadence independent of diagnostics (reference:
        # FORCE_OUTPUT_FREQ falling back to DIAG_FREQ, config_loader.jl:192)
        if force_ctx is not None and fof > 0 and t_done % fof == 0:
            last_forces = _forces()
            append_forces(force_csv, t_done, t_done * params.time_scale,
                          last_forces, _ramp_host(t_done, cfg))

        if t_done % cfg.diag_freq == 0 or t_done == cfg.steps:
            sync()
            now = time.time()
            # MLUPS-ref: cells x coarse steps (reference: main.jl:188-190)
            mlups = total_cells * cfg.diag_freq / max(now - last_diag_time, 1e-9) / 1e6
            last_diag_time = now
            stats = compute_flow_stats(global_level(0), obstacle0)
            final_stats = stats
            u_curr = _ramp_host(t_done, cfg)
            cd_str = cl_str = "N/A"
            if force_ctx is not None:
                # display only: forces.csv rows come at the force cadence
                if last_forces is None or t_done % fof != 0:
                    last_forces = _forces()
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
                    # checkpoint the state and end the case (the batch runner
                    # isolates per-case failures, so later cases still run)
                    path = ckpt.save_checkpoint(ckpt_dir, t_done, host_states())
                    log.error("[Stability] step %d: divergence detected "
                              "(stability_action=abort); state saved to %s",
                              t_done, path)
                    raise RuntimeError(
                        f"simulation diverged at step {t_done}: {warns[0]}")

        if cfg.output_freq > 0 and t_done % cfg.output_freq == 0:
            path = os.path.join(out_dir, f"flow_{t_done:06d}.vtu")
            t0 = time.time()
            (export_flow_vtu if blocks else export_flow_vtu_patches)(
                path, levels, host_states(), cfg.output_fields)
            outputs.append(("flow", t_done, path, time.time() - t0))
            if force_ctx is not None:
                if last_forces is None or t_done % cfg.diag_freq != 0:
                    last_forces = _forces()
                path = os.path.join(out_dir, f"surface_{t_done:06d}.vtu")
                t0 = time.time()
                export_surface_vtu(path, mesh.vertices, mesh.normals, mesh.areas,
                                   last_forces.pressure_map, last_forces.shear_map)
                outputs.append(("surface", t_done, path, time.time() - t0))

        if cfg.checkpoint_freq > 0 and t_done % cfg.checkpoint_freq == 0:
            # the host fetch is synchronous (the next launches write the
            # buffers); the zip/disk write overlaps the next steps
            t0 = time.time()
            path = ckpt.save_checkpoint(ckpt_dir, t_done, host_states(),
                                        async_write=True)
            outputs.append(("checkpoint", t_done, path, time.time() - t0))
            log.info("[Checkpoint] saved %s (fetch %.2f s; write async)", path,
                     outputs[-1][3])

        if prof is not None and profile_dir:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, f"trace_{t}_{t_done}.json")
            prof.export_chrome_trace(trace)
            log.info("[Profile] trace of steps %d-%d written to %s", t, t_done, trace)
            profile_dir = None
        t = t_done + 1

    ckpt.wait_pending()  # a checkpoint write may still be in flight
    sync()
    windows = [(a, b, float(ev[0].elapsed_time(ev[1]))) for a, b, ev in events]
    wall_total = time.time() - t_start
    # MLUPS-ref = total cells x COARSE steps / wall (the reference's
    # convention, main.jl:188-190); MLUPS-su counts site updates
    # (cells x 2^(level-1)) and is what the chip smoke reports beside it
    mlups_total = (total_cells * (cfg.steps - resume_step) / max(wall_total, 1e-9)
                   / 1e6)
    log.info("=" * 70)
    log.info("  COMPLETE | wall %.1f s | %.1f MLUPS-ref end-to-end (cells x "
             "coarse-steps, set-up included)", wall_total, mlups_total)
    if last_forces is not None:
        log.info("\n%s", print_force_summary(
            last_forces, params.rho_physical, params.u_physical,
            params.reference_area, params.reference_chord))
        # time-averaged coefficients over the final third of the run, the
        # meaningful number for unsteady (vortex-shedding) flows
        with open(force_csv) as fh:
            rows = list(csv.DictReader(fh))
        cut = cfg.steps - max(cfg.steps // 3, 1)
        cds = [float(r["Cd"]) for r in rows if int(r["Step"]) >= cut]
        cls_ = [float(r["Cl"]) for r in rows if int(r["Step"]) >= cut]
        if cds:
            log.info("  time-averaged (last third): Cd = %.4f +- %.4f | "
                     "Cl = %.4f +- %.4f", float(np.mean(cds)), float(np.std(cds)),
                     float(np.mean(cls_)), float(np.std(cls_)))
    log.info("[Spans] the case's host spans and counters:\n%s",
             spans.report(spans.since(spans_at)))
    return SolveResult(
        total_cells=total_cells, updates_per_coarse=updates, steps=cfg.steps,
        wall_time=wall_total, mlups=mlups_total, final_stats=final_stats,
        final_forces=last_forces, windows=windows, resume_step=resume_step,
        outputs=outputs,
        graph_report=(run.graph_set.report() if run.graph_set is not None
                      else getattr(run, "graph_note", None) or "graphs off"),
    )


def run_all_cases(cases_root: str, batch_file: str, device="cuda") -> List[str]:
    """Iterate case folders with per-case error isolation (reference:
    main.jl:251-274); returns the names of the cases that failed.  Each
    case runs on its own `devices` (`solve_case`)."""
    resolve_device(device)  # no CUDA: raise once, not once per case
    cases = load_batch_list(batch_file)
    log.info("MULTI-CASE EXECUTION: %d cases", len(cases))
    failed = []
    for i, name in enumerate(cases):
        log.info(">>> CASE %d/%d: %s", i + 1, len(cases), name)
        try:
            solve_case(load_case_config(os.path.join(cases_root, name)), device=device)
        except Exception:
            log.exception("!!! case %s failed", name)
            failed.append(name)
    log.info("ALL CASES COMPLETED (%d failed)", len(failed))
    return failed


def plan_case(cfg: CaseConfig, device="cuda") -> Dict:
    """Build the domain and the statics on `device` and print the set-up
    and device-memory report without running: the reference's domain
    summary and capacity planning (reference: physics_scaling.jl:178-187,
    diagnostics_vram.jl).  The capacity is what the card's kernel rule
    plans for, the card's memory less its reserve (`memory.card_capacity`),
    in cells of one level (`memory.level_capacity`); on the CPU it is not
    estimated.  With `devices: n` the statics are cut over n slabs
    (`make_x_mesh`, which raises when fewer cards are visible) and the
    memory is reported per slab and card; the capacity is one card's, times
    the mesh's cards.  The kernels are the card's rule's for that capacity
    (no limit on the CPU)."""
    check_supported(cfg)
    dev = resolve_device(device)
    x_mesh = resolve_mesh(cfg, dev, None)
    if x_mesh is not None:
        dev = x_mesh.devices[0]
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    log.info("Case: %s | %d triangles", os.path.basename(cfg.case_dir),
             mesh.n_triangles)
    log.info("Re = %.3e | levels = %d | dx_fine = %.5g m | tau = %s",
             params.re_number, params.num_levels, params.dx_fine,
             ", ".join(f"{t:.6f}" for t in params.tau_levels))
    log.info("domain = %.2f x %.2f x %.2f m | coarse grid %dx%dx%d",
             *params.domain_size, params.nx_coarse, params.ny_coarse,
             params.nz_coarse)
    patches = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, patches, dev, x_mesh=x_mesh)
    log.info(hbm_report_patches(patches, statics, cfg.precision, dev, x_mesh=x_mesh))
    for line in kernel_log_lines(patches, statics, cfg.precision, dev, x_mesh=x_mesh):
        log.info(line)
    total = sum(p.n_cells for p in patches)
    upd = sum(p.n_cells * 2 ** (p.level_id - 1) for p in patches)
    log.info("total %.2fM cells | %.2fM site-updates per coarse step | %d steps",
             total / 1e6, upd / 1e6, cfg.steps)
    cap = None
    if dev.type == "cuda":
        cards = 1 if x_mesh is None else len(set(x_mesh.devices))
        per_card = memory.card_capacity(dev)
        fb = storage.f_dtype(cfg.precision).itemsize
        cap = {eng: cards * memory.level_capacity(per_card, fb, eng)
               for eng in ("k1", "inplace")}
        log.info("capacity: ~%.0fM cells on A->B levels (~%.0fM in place) fit "
                 "%d card(s) of %.1f GB less the reserve (%.1f GB planned) -> this "
                 "case uses %.1f%%", cap["k1"] / 1e6, cap["inplace"] / 1e6, cards,
                 torch.cuda.mem_get_info(dev)[1] / 1e9, per_card / 1e9,
                 100.0 * total / cap["k1"])
    else:
        log.info("capacity: not estimated on the CPU (the card's memory sets it)")
    return {"total_cells": total, "updates_per_coarse": upd, "capacity": cap}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    ap = argparse.ArgumentParser(prog="python -m open_ludwig_torch.runner")
    ap.add_argument("case_dirs", nargs="*", help="case directories (config.yaml + STL)")
    ap.add_argument("--plan", action="store_true",
                    help="print the set-up and memory report of each case; no run")
    ap.add_argument("--batch", metavar="CASES_YAML",
                    help="run the case folders listed in CASES_YAML under the "
                    "root given as the one positional argument (default CASES)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.batch:
        if len(args.case_dirs) > 1:
            ap.error("--batch takes at most one cases root")
        run_all_cases(args.case_dirs[0] if args.case_dirs else "CASES", args.batch,
                      device=args.device)
        return 0
    if not args.case_dirs:
        ap.error("give at least one case directory")
    for case_dir in args.case_dirs:
        cfg = load_case_config(case_dir)
        if args.plan:
            plan_case(cfg, device=args.device)
        else:
            solve_case(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

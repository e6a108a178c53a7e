#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (open_ludwig_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reference DIR]

`--reference DIR` (also `--k1-reference`) names a directory holding an
earlier `csrc/` (an earlier commit's sources and headers): each of K1-K6
whose source it holds is built from it too, run beside today's kernel on
the same inputs (K1 on every phase-3 and 3e input, K4 and K5 on phase
3c's and 3d's, K3 on 4b's, K2 and K6 on the bench box) and timed against
it in turns, eager and (K1, K2, K4, K6) from a CUDA graph, with the share
of stored f entries that differ printed.
Without it (as the smoke run is meant to be run) nothing else changes.

Phases, each raising on failure (nothing is caught):
  1. device: CUDA must be available; prints the card, `nvidia-smi` name and
     power limit, and the toolchain;
  2. build: K1 (csrc/stream_collide.cu), K2 (csrc/bouzidi.cu), K3
     (csrc/fused_pair.cu), K4 (csrc/stream_collide_flat.cu), K5
     (csrc/stream_collide_inplace.cu), K6 (csrc/bouzidi_ab.cu) and the
     ghost planes' kernels (csrc/ghost_planes.cu) with nvcc
     for sm_90a into build/kernels/, one nvcc per source, all at once;
     prints registers, spills and K3's and K5's shared memory and occupancy
     (K5's at the 63.7M-cell row's layout);
  3. K1 against its plain PyTorch version on the card, on the bench case's
     levels (wall model, sponge blend, inlet noise 0.02, every face type;
     interface faces read pre-shifted (27, A, B) ghost planes in the
     storage type, bf16 g-space on bf16, `checks.random_level_inputs`)
     and on a 10.8M-cell single-level sweep shape, float32 and bf16;
  3b. the ghost planes of the bench case's level-2 and level-3 children
     (the einsum plan, the endpoint slabs, `interface_planes_pair_mm`: the
     plain versions, which phase 15 holds the kernels to) against the
     endpoint path + `shift_planes` on the card, float32 and
     bf16 parents: float32 planes < 2e-6, the storage-type planes within
     2e-3 of the endpoint path's cast alike; one child build timed
     eagerly (ms, and its device operations by torch.profiler) beside the
     endpoint path's;
  3e. K1 at the level shapes of the benchmark's cells (the headline's L2
     and L3 in bf16, Re10M's L2-L4 and the 400^3 row in float32, with the
     cells' face types): against its plain version (but on the row), and
     from a CUDA graph beside its bound; with --reference bit for bit
     against the reference's K1, both times in turns;
  3c. K4 against its plain version and against K1 (share of stored f
     entries that differ, expected 0), float32 and bf16, on the bench
     case's level 1 (64x56x56, which the bench runs on K4), on that level
     cut to 61 x planes (an x extent no flat PX of the TPU's divides: the
     card's rule runs such a level on K4 too) and on the 10.8M-cell shape,
     timed against K1 in turns eager and replayed from a CUDA graph (K4
     into preallocated outputs), with K4's registers and spills;
  3d. the same for K5 (the same three shapes), each call on its own clone
     of the input (K5 must equal K1 bit for bit), timed against K1 in
     turns, with its two
     launches (edge copy, step) timed apart, its layout and its occupancy;
  4. K2 against its plain version on the bench case's own Bouzidi box: one
     launch over the plan's links, its bound from the links' work beside
     the box sweep's, and no byte allocated per call;
  4b. K3 (+ K2) against the plain pair and against K1 -> K2 -> K1 (+ K2),
     float32 and bf16, on the bench's finest level (six interface faces,
     distinct ghost planes per sub-step: plane[0] and plane[1] of each
     face's (2, 27, A, B) storage-type tensor, box 29x28x28), on the 10.8M-cell
     single level (inlet, outlet, mirrors, inlet noise, wall model, sponge
     ramp, the sphere's box) and on the levels of the bench's sweep rows
     at res 12 and 25 (`bench.build_row`: 1.6M and 13.8M cells, z snapped
     to 128 and 256, each with its own Bouzidi box, on which K2 is held
     against its plain version first, float32 and bf16); times K3 against
     the unfused kernels in turns, and the plain pair; prints K3's
     registers and occupancy;
  4c. the card's default against the JAX package's schedule: 20 coarse
     steps of the bench case through make_batch_runner_dense at its default
     (unfused: level 3 on K1 + K2) and with fuse2=True (level 3's sub-step
     pairs on K3 + K2, the former default) from one random state, float32
     and bf16: launch counts of each, every level bit-equal; the fused bf16
     run's K3 launches are the kernels line's;
  5. the slice: `open_ludwig_torch.runner.solve_case` on the bench case
     (sphere Re~1M, N=25, 3 levels + wake, wall model, Bouzidi, bf16
     g-storage) for 400 coarse steps, each level on the card's rule (K4,
     K1, K1), unfused by default: finite CSVs, rho_min in (0.5, 1.5),
     launch counts per coarse step K4 = 1 (level 1), K1 = 2 + 4 (levels 2
     and 3), K2 = 4 (level 3), and the fused ghost build's 3 (a child
     build each of levels 2 and 3's sub-steps, one launch, no slab seeded;
     the kernels line's launches), the peak allocation beside the estimate the
     card's rule reads (`[memory]`), and MLUPS-su /
     MLUPS-ref from CUDA events over the post-warm-up intervals; then 10
     coarse steps after 20 of warm-up, one batch-runner call each, timed
     with CUDA events and then profiled (`tools/profile_slice.py`): every
     CUDA kernel, memcpy and memset per coarse step beside the port's own
     launches, the device time of the port's kernels and of the rest, and
     the device-busy share of the profiled window;
  6. the single-level path: `solve_case` on the 10.8M-cell case (bf16,
     75 coarse steps in batches of 25, unfused): finite CSVs, rho_min in
     (0.5, 1.5), K1 = K2 = one a coarse step, the peak beside the estimate,
     and MLUPS from CUDA events over the batches after the first; then one
     checkpoint of a
     perturbed state of the level saved (the host fetch and the zip write
     timed apart) and loaded back bit for bit, with its size; then one
     50-step batch of the runner fused and unfused, in turns, timed with
     CUDA events;
  7. the 63.7M-cell single-level row (surface_resolution 45, bf16,
     domain_tile_snap), whose level the reference runs with its in-place
     2-D kernel: `solve_case` at the card's capacity (20 coarse steps in
     batches of 10): the card's rule runs K1, its A -> B estimate fitting
     the capacity (launch counts K1 = K2 = steps, no K3, K4 or K5), finite
     CSVs, rho_min in (0.5, 1.5), MLUPS
     from CUDA events over the batches after the first, the peak beside
     the estimate.  Then, on the row's level rebuilt as solve_case builds
     it: K5 against its plain version (bf16 2e-3) and K1 (0 stored f
     differ), K2 against its plain version on the row's Bouzidi box (no
     byte allocated per call), the peak allocation above the live state of
     one K5 step (at most rho + vel + 25% of one f copy) and of one K1
     step (a whole second f); the card's rule under a capacity cut between
     the row's K5 and K1 estimates: it picks K5, whose graphed 10-step
     batch (K5 = K2 = 10 launches, the kernels line's K5 count) peaks under
     the cut; and 10 steps from one perturbed state on the default (K1
     unfused), on K5 and on K3 pairs, all three bit-equal, each timed in
     turns;
  8. the probe's path: K6 against its plain version on the bench case's
     own Bouzidi box, float32 (1e-6) and bf16 (2e-3, decoded f), and
     against K2 on the same S (under the same bounds; both run one launch
     over their links), no byte allocated per call, timed against K2 in
     turns eager and from a CUDA graph; then
     `open_ludwig_torch.tools.probe_bz_encoding` at its defaults (the bench
     case's finest box, K2 against K6 from one bf16 state, then interleaved
     windows of 300 applications, CUDA events, and each replayed from a
     CUDA graph), whose windows must launch each of K2 and K6 once per
     application and nothing else;
  9. the runner's outputs and restarts, on the bench case:
     9b. `solve_case` with `forces.method: momentum_exchange`, `output_freq`
     100, `checkpoint.freq` 100, 200 coarse steps: launch counts per coarse
     step as phase 5's, two flow_*.vtu and two surface_*.vtu files that
     decode (`io.vtk.read_vtu`) with finite Velocity, finite CSVs (MEM Cd),
     each export's ms and MB, and one checkpoint of the final state saved
     with the host fetch and the zip write timed apart;
     9a. `make_mem_context` on the finest level (its link count) and MEM on
     the card from 9b's final state against a float64 evaluation of the
     same links on a host copy of f, within 1e-5 x the sum of |link
     contribution| per component (`checks.mem_float64`); one MEM and one
     stress-mapping evaluation timed eagerly with CUDA events;
     9c. the run resumed from its step-100 checkpoint to step 200 (launch
     counts for 100 coarse steps): its final f, rho and vel equal 9b's bit
     for bit, and the CSVs hold each step once;
     9d. `plan_case` on the bench case, with the capacity from the card's
     own memory.
  10. the x-slab multi-device path (`parallel.patch_shard`) on virtual
     meshes of slabs on the one card:
     10a. the sharded forms against their plain versions on the same slab
     inputs (K1/K4/K5 1e-5 / 2e-3, K2 1e-6 / 2e-3) and against the
     unsharded kernel on the whole level (the slab's stored f entries
     equal, 0 differing), at the slabs 10b and 10c run them, float32 and
     bf16: K1 on the first of 2 slabs of the bench's level 3, the middle
     of 3 of level 2, and the first (inlet) and last (outlet) of 3 of level
     1; K4 on the first (inlet) and last (outlet) of 2 and of 3 of level 1
     (the bench's level 1 runs K4 on 3 slabs too, 10b); K5 on
     both slabs of the 63.7M-cell row (bf16, its storage type; float32 on
     the first of 2 slabs of the 10.8M-cell shape); K2 at the bench's
     2- and 3-slab bounds (both cut its box: every slab reads a halo) and
     at the row's 2-slab bounds (bf16);
     10b. the bench case with momentum-exchange forces through
     `solve_case(cfg, x_mesh=...)` on 2 and 3 slabs (3 uneven), 100 coarse
     steps with a checkpoint at 100: launch counts per coarse step from the
     sharded statics (no unsharded kernel), f, rho and vel of every level
     bit-equal to the single-device unfused batch runner's, the run's
     final forces equal to one device's on that state (which are within
     1e-5 x the sum of |link contribution| of float64,
     `checks.mem_float64`); then 50 coarse steps timed with CUDA events for
     n = 1 (unfused), 2, 3 in turns;
     10c. the 63.7M-cell row on 2 slabs: the card's rule (both slabs on
     the one card add up) picks K1 at the card's capacity and K5 under a
     cut between the two estimates; on K5 + K2 sharded, graphed, 10 steps
     from phase 7's perturbed state, bit-equal to the unsharded eager loop
     (`graphs=False`, K1), with the peak allocation of one sharded coarse
     step;
     10d. `solve_case` with `devices: 2` and no mesh raises on a one-card
     machine.
  11. the blocks layout (the JAX package's sparse 8^3-block path, plain
     PyTorch float32 with no kernel of its own, as in the JAX package) and
     `async_depth`:
     11a. the bench case with `layout: blocks`, float32, through
     `solve_case` on the card, 200 coarse steps, diagnostics every 50: no
     port kernel launched, finite CSVs, rho_min in (0.5, 1.5), a finite Cd;
     the blocks of each level (392 / 1,000 / 1,728, 1.60M cells), the
     `hbm_report` estimate beside `torch.cuda.max_memory_allocated`, ms per
     coarse step, MLUPS-su and MLUPS-ref from CUDA events over the windows
     after the first, and 10 coarse steps profiled (`tools/profile_slice`):
     CUDA device operations per coarse step and the device-busy share;
     11b. a single-level sphere on both layouts from rest, 4 coarse steps
     on the card: the blocks step against the patch layout's plain step,
     f and vel within 5e-6, and the difference from K1 printed;
     11c. the bench case (patch, bf16) for 20 coarse steps with
     `async_depth` 3 and 0: final states bit-equal, the same CSV steps.
  12. the shipped cases (`CASES/`) on the card through `solve_case`, each
     cut to 200 coarse steps (diagnostics and forces every 50): the cube
     (4 levels), the wing at 5 degrees (3 levels, a Bouzidi box 10 cells
     thick), the Re~10M sphere (4 levels) and the half model of the Re~1M
     sphere (`symmetric_analysis`, its Bouzidi box on the finest level's
     y = 0 face): launch counts per coarse step from the kernel each level
     takes (K4 / K1 per sub-step, K2 after each of the finest's), finite
     CSVs, rho in (0.5, 1.5), ms per coarse step, MLUPS-su and MLUPS-ref
     from CUDA events over the intervals after the first, 10 coarse steps
     profiled (`tools/profile_slice.py`: CUDA device operations and the
     device-busy share), the peak allocation of the run beside the
     estimate; then each level's
     kernel against its plain version at the case's shapes (K4 also
     against K1, equal; K1 on the inner levels; K2 on the finest box; K3 +
     K2 against the plain pair and against K1 -> K2 -> K1); last, the
     Re~1M validation case (`tools/validate_spheres`, float32, wall model
     on) for 600 coarse steps past the ramp from one perturbed state, K3
     pairs twice and K1 -> K2 -> K1, all three bit-equal.
  13. the batch as one program (`graphs.py`): each case's batch runner
     graphed (each coarse step, or pair, one CUDA graph replay, the inlet
     speed and seeds read from the step record on the card) against its
     eager loop (`graphs=False`, every launch from the host) from one
     perturbed state with inlet noise 0.02, over calls (1, 7), (8, 12),
     (20, 3), (23, 18) across a 20-step ramp: the states bit-equal and the
     kernel launches executed equal (the graphed run's are its captured
     launches times its replays, fewer issued by the wrappers), float32
     and bf16, on the bench case (13a), CASES/cube (13b, 4 levels, unfused
     and with fuse2=True: level 4's pairs on K3), the
     10.8M-cell pair runner (fuse2=True: K3 pairs, an odd call's plain
     step first) and the same level on K5 in place (13c), the
     bench on 2 virtual slabs (13d) and
     the bench on layout: blocks (13e, float32); then, for one type of
     each, 20 coarse steps a call in turns graph, eager, eager, graph
     (`tools/profile_slice.turns`): ms per coarse step, CUDA device
     operations, device-busy share and peak allocation; and `solve_case`
     on the bench graphed and eager, 40 steps: forces.csv rows identical.
     The phases above that count launches a coarse step read
     `cuda_step.executed_launches()`, the runners being graphed there too.
  14. the bench entry point (`open_ludwig_torch.bench`): `headline("cuda")`
     in full (the bench case built 3 times, each from rest, warm-up calls
     until all replays, then 6 windows of 400 coarse steps between CUDA
     events): its JSON fields printed with the card, finite MLUPS with
     min <= median <= max, each build's median, no launch captured in the
     timed windows, launches executed per coarse step K4 1, K1 6, K2 4
     (the engines K4, K1, K1 + K2), the largest build's peak beside the
     estimate, and the median ms per coarse step over the builds
     within 20% of phase 13's graphed bench turns; then one sweep row,
     `sweep((12,), "cuda", <tmp>)` (1.6M cells): the row schema, no error,
     its engine (K1 + K2) and peak memory beside the estimate.
  15. the ghost planes' kernels (`ops.ghost_planes`, csrc/ghost_planes.cu)
     against their plain versions (`checks.check_ghost_kernels`) on the
     shipped Re10M sphere's three child builds (float32), the bf16
     bench's two (g slabs, g planes) and the geometries of
     `checks.GHOST_GEOMS` (a group of one face, two groups, the clamp, an
     offset parent; float32 and bf16), temporal on and off: the endpoint
     slabs bit-equal, float32 planes < 2e-6, bf16 planes the kernel's
     float32 ones rounded and at most one bf16 ulp beyond the float32
     planes' distance from the plain ones (`checks.bf16_ulps`), and the
     fused build (`ghost_planes.build`, one launch from the parent's two
     states) bit-equal to the two kernels' planes, float32 and in the
     storage type; each two-kernel build's time (extraction and planes)
     from a CUDA graph beside its byte bound and the plain build's, each
     kernel's and the carry's copy beside theirs, and the fused build's
     beside its own bound; then the Re10M batch runner graphed against
     its eager loop (`GHOST_CALLS15`) with level 1 on K4 (every build
     fused) and on K5 (a capacity of one byte: level 2 built by the two
     kernels from carried slabs): bit-equal, the builds counted as
     "planes.fused" or "planes.kernel" and none as "planes.plain", the
     kernels' executed launches (`ghost_planes.executed_launches`) those
     of the steps and seedings (`ghost_launches`), `cuda_step.LAUNCHES`
     with the keys it had, and the K4 and K5 runs' states bit-equal.
  16. a force sample as one graph replay and one read-back
     (`ops.forces.ForceGraphs`) on the finest level of the benchmark's
     `sphere_re10m.samples` program (`lbm_bench.harness.Program`) after
     three calls of 10 coarse steps from its warm start: 50 evaluations on
     the graph path against 50 of the eager, five-copy one (`eager_sums`),
     Cd/Cl/Cs, the nine sums and both maps bit for bit, one capture and 49
     replays, one blocking copy a sample against five, `graph.ops` /
     `graph.steps` unmoved, the host ms a sample on each path (median of
     50, the card drained before each) and the force graphs' pool; then a
     call later (the replay reading the state where it lies) and on two
     copies of the state (the second graph, then past the cap an eager
     evaluation with one read-back), each bit-equal to the eager path.
Every run's device-memory estimate (`solver_dense.hbm_total_patches`, the
card's rule's) must be at or above its allocated peak, and with the card's
reserve (`memory.card_reserve`) at or above what the run reserved (the
larger of its allocated peak and the caching allocator's reservations
above theirs at its start) plus the CUDA context (`bench.memory_fields`;
`[memory]` lines, checked at the end).  The earlier phases' objects are
released before the later runs, so that their free blocks are few.
Every check prints its bound beside its time: the bytes the call must
move over the card's memory rate (or its operations over the float32
rate, where larger; `checks.bound`).  Before the last lines, neither jax
nor any module of the JAX package may be loaded.  Prints one JSON line of
kernel results, the card's name and power limit, then, as its last line,
{"ok": true, "device": {...}}.  Exits non-zero without CUDA.
"""

import csv
import dataclasses
import json
import logging
import os
import re
import sys
import tempfile
import time


def measured(v, spec: str = ".1f", scale: float = 1.0) -> str:
    """A profiled number, or "not measured" where the trace was incomplete
    (`profile_slice.drop_incomplete`)."""
    return "not measured" if v is None else f"{v * scale:{spec}}"


def require(ok: bool, what) -> None:
    """Fail the phase: raises (not assert, which -O would strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_10(dev, smi, kw, tmp, trimesh, params, levels, statics, sweep, row7):
    """Phase 10, the x-slab path on virtual meshes of the one card (module
    docstring).  `sweep` is the 10.8M-cell level and its statics, `row7`
    phase 7's (cfg, params, levels, unsharded statics, perturbed state) of
    the 63.7M-cell row.  Returns the sharded kernels' check results by
    kernel and their launches on the main path's runs."""
    import numpy as np
    import torch

    from open_ludwig_torch import checkpoint as ckpt
    from open_ludwig_torch import checks, memory
    from open_ludwig_torch.ops import cuda_step, forces
    from open_ludwig_torch.parallel.patch_shard import (
        XMesh, gather_states, shard_states, slab_bounds)
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver_dense import (
        build_patch_statics, init_patch_state, make_batch_runner_dense)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def states_equal(a, b):
        return all(torch.equal(bits(x[k]), bits(y[k]))
                   for x, y in zip(a, b) for k in ("f", "rho", "vel"))

    def vmesh(n):
        return XMesh([dev] * n)

    res = {"stream_collide_shard": [], "stream_collide_flat_shard": [],
           "stream_collide_inplace_shard": [], "bouzidi_shard": []}
    t_phase = time.time()

    # ---- 10a. each sharded form against its plain version ----
    # at the slabs the main path's runs give it: K1 on the bench's levels at
    # 2 and 3 slabs (level 1, inlet and outlet, on 3), K4 on level 1's
    # slabs of 2 and 3 (inlet, outlet), K5 on the 63.7M-cell row's two
    # slabs (bf16, as 10c runs it); K5's float32 form, which no path runs,
    # on a slab of the 10.8M-cell shape
    sweep_level, sweep_static = sweep
    _, _, levels7, statics7, _ = row7
    both, bf_only, f32_only = (False, True), (True,), (False,)
    cases = (
        ("stream_collide_shard", "k1", "L3 first of 2", levels[2], statics[2], 2, 0, both),
        ("stream_collide_shard", "k1", "L2 middle of 3", levels[1], statics[1], 3, 1, both),
        ("stream_collide_shard", "k1", "L1 first of 3 (inlet)", levels[0], statics[0], 3, 0,
         both),
        ("stream_collide_shard", "k1", "L1 last of 3 (outlet)", levels[0], statics[0], 3, 2,
         both),
        ("stream_collide_flat_shard", "flat", "L1 first of 2 (inlet)", levels[0], statics[0],
         2, 0, both),
        ("stream_collide_flat_shard", "flat", "L1 last of 2 (outlet)", levels[0], statics[0],
         2, 1, both),
        ("stream_collide_flat_shard", "flat", "L1 first of 3 (inlet)", levels[0], statics[0],
         3, 0, both),
        ("stream_collide_flat_shard", "flat", "L1 last of 3 (outlet)", levels[0], statics[0],
         3, 2, both),
        ("stream_collide_inplace_shard", "inplace", "row first of 2 (inlet)", levels7[0],
         statics7[0], 2, 0, bf_only),
        ("stream_collide_inplace_shard", "inplace", "row last of 2 (outlet)", levels7[0],
         statics7[0], 2, 1, bf_only),
        ("stream_collide_inplace_shard", "inplace", "sweep first of 2", sweep_level,
         sweep_static, 2, 0, f32_only),
    )
    for kname, kind, label, patch, static, n, i, dtypes in cases:
        for bf16 in dtypes:
            big = patch.n_cells > 20e6
            r = checks.check_shard_step(kind, patch, checks.with_sponge_ramp(static),
                                        bf16, seed=61, kw=kw, device=dev, n=n, i=i,
                                        reps=5 if big else 20, plain_reps=1)
            res[kname].append((bf16, r))
            x0, x1 = r["slab"]
            print(f"[10a shard] {kname} {label} {patch.interior} x [{x0},{x1}) "
                  f"{'bf16' if bf16 else 'f32 '} | vs plain: err f/rho/vel "
                  f"{r['err']['f']:.2e}/{r['err']['rho']:.2e}/{r['err']['vel']:.2e} "
                  f"(tol {r['tol']:.0e}) | vs the unsharded kernel's rows: "
                  f"{100 * r['whole']['diff_frac']:.4f}% stored f differ, max "
                  f"{r['whole']['max_abs_err']:.2e} | kernel {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms | card: {smi}",
                  flush=True)
            require(r["finite"] and r["max_abs_err"] < r["tol"]
                    and r["whole"]["diff_frac"] == 0.0, (kname, label, bf16, r["err"],
                                                         r["whole"]))
            if big:
                torch.cuda.empty_cache()
    # K2 at the bench's slab bounds of 2 and 3 slabs (10b: both cut its box,
    # so slabs read halos) and of the row's 2 (10c, bf16)
    plan = statics[2]["bouzidi"]
    X3 = levels[2].interior[0]
    k2_cases = (
        ("bench, 2 slabs", levels[2], plan, slab_bounds(X3, 2), both),
        ("bench, 3 slabs", levels[2], plan, slab_bounds(X3, 3), both),
        ("row, 2 slabs", levels7[0], statics7[0]["bouzidi"],
         slab_bounds(levels7[0].interior[0], 2), bf_only),
    )
    for label, patch, bplan, cut, dtypes in k2_cases:
        for bf16 in dtypes:
            r = checks.check_bouzidi_shard(patch, bplan, bf16, seed=63, bounds=cut,
                                           device=dev)
            res["bouzidi_shard"].append((bf16, r))
            print(f"[10a shard] bouzidi_shard {label}: box {tuple(bplan['dim'])} at x "
                  f"{bplan['lo'][0]}, slabs at x {cut} {'bf16' if bf16 else 'f32 '} | "
                  f"links per slab {r['links']}, halo values {r['halo']} | vs plain: "
                  f"err {r['max_abs_err']:.2e} (tol {r['tol']:.0e}, {r['changed']} "
                  f"slots changed) | vs the unsharded K2: "
                  f"{100 * r['whole']['diff_frac']:.4f}% stored f differ | halos + "
                  f"every slab {r['ms']:.5f} ms, bound {r['bound_ms']:.6f} ms, plain "
                  f"{r['plain_ms']:.3f} ms | card: {smi}", flush=True)
            require(r["changed"] > 0 and r["max_abs_err"] < r["tol"]
                    and r["whole"]["diff_frac"] == 0.0
                    and (min(r["halo"]) > 0 or not label.startswith("bench")),
                    ("bouzidi_shard", label, bf16, r))
    torch.cuda.empty_cache()

    # ---- 10b. the bench case on 2 and 3 virtual slabs ----
    steps = 100
    cfg10 = checks.bench_config(os.path.join(tmp, "shard"), steps=steps,
                                diag_freq=50).with_overrides(
        checkpoint_freq=steps, force_method="momentum_exchange")
    stat1 = build_patch_statics(cfg10, levels, dev)
    single = make_batch_runner_dense(cfg10, params, levels, stat1, fuse2=False)
    ref = single([init_patch_state(p, cfg10.precision, dev) for p in levels], 1, steps)
    # one device's forces of the final state, computed as solve_case does
    ctx = forces.make_mem_context(levels[-1], params, trimesh, g_storage=True,
                                  device=dev)
    sctx = forces.make_force_context_dense(trimesh, levels[-1], params,
                                           extrapolate=cfg10.force_extrapolate,
                                           device=dev)
    want_forces = forces.compute_aerodynamics_mem(
        ref[-1], ctx, base=forces.compute_aerodynamics(ref[-1], sctx))
    f64 = checks.mem_float64(ref[-1]["f"], ctx)
    e = checks.mem_errors(want_forces, f64)
    launches = {}
    for n in (2, 3):
        mesh = vmesh(n)
        stat_n = build_patch_statics(cfg10, levels, dev, x_mesh=mesh)
        want = {k: 0 for k in cuda_step.LAUNCHES}
        for li, st in enumerate(stat_n):
            sub = 2 ** li * steps
            want[{"k1": "stream_collide_shard", "flat": "stream_collide_flat_shard",
                  "inplace": "stream_collide_inplace_shard"}[st["engine"]]] += n * sub
            want["bouzidi_shard"] += sub * sum(sh["bouzidi"] is not None
                                               for sh in st["shards"])
        out_dir = f"RESULTS_{n}"
        cuda_step.reset_launches()
        t0 = time.time()
        r = solve_case(cfg10.with_overrides(output_dir=out_dir), device="cuda",
                       x_mesh=mesh)
        got = cuda_step.executed_launches()
        sec = time.time() - t0
        require(got == want, (f"sharded launches on {n} slabs", got, want))
        if n == 2:
            launches = got
        path = os.path.join(cfg10.with_overrides(output_dir=out_dir).output_path,
                            "checkpoints", f"ckpt_{steps:08d}.npz")
        _, final = ckpt.load_checkpoint(path, cfg10.precision, dev)
        equal = states_equal(final, ref)
        same_forces = all(getattr(r.final_forces, k) == getattr(want_forces, k)
                          for k in ("Fx", "Fy", "Fz", "Mx", "My", "Mz", "Cd", "Cl"))
        print(f"[10b shard] bench on {n} virtual slabs ("
              + ", ".join(f"L{p.level_id} {st['engine']} x {st['bounds']}"
                          for p, st in zip(levels, stat_n))
              + f"): solve_case {steps} steps in {sec:.1f} s (set-up included) | "
              f"launches {dict((k, v) for k, v in got.items() if v)} | every level's "
              f"f, rho, vel bit-equal to one device unfused: {equal} | final MEM "
              f"forces equal to one device's on that state: {same_forces} (their "
              f"|error| / bound against float64: F {e['F']:.3f}, M {e['M']:.3f}) | "
              f"Cd {r.final_forces.Cd:.5f}, rho_min {r.final_stats.rho_min:.4f} | "
              f"card: {smi}", flush=True)
        require(equal and same_forces and e["ok"] and np.isfinite(r.final_forces.Cd)
                and 0.5 < r.final_stats.rho_min < 1.5, (f"bench on {n} slabs", e))
        del final
    runs = {1: single}
    for n in (2, 3):
        mesh = vmesh(n)
        runs[n] = make_batch_runner_dense(
            cfg10, params, levels, build_patch_statics(cfg10, levels, dev, x_mesh=mesh),
            x_mesh=mesh)
    turns = []
    for n in (1, 2, 3, 3, 2, 1):
        st = ref if n == 1 else shard_states(ref, vmesh(n))
        runs[n](st, steps + 1, 2)  # seeds the slabs, warms up
        turns.append((n, checks.time_cuda(lambda: runs[n](st, steps + 1, 50), reps=1,
                                          warmup=0) / 50))
        del st
    print("[10b shard] 50 coarse steps of the bench, ms per coarse step in turns "
          "(n slabs; n = 1 one device unfused; virtual mesh: every slab on this "
          "one card, one stream): " + ", ".join(f"n={n} {ms:.3f}" for n, ms in turns)
          + f" | card: {smi}", flush=True)
    del ref, runs, stat1, single
    torch.cuda.empty_cache()

    # ---- 10c. the 63.7M-cell row on 2 slabs ----
    # the card's rule on a virtual mesh: both slabs on this card add up; at
    # the card's capacity they run K1, under a cut between the sharded K5
    # and K1 estimates K5, which this run holds to one device
    cfg7, params7, levels7, statics7, state7 = row7
    mesh = vmesh(2)
    stat_k1 = build_patch_statics(cfg7, levels7, dev, x_mesh=mesh)
    bounds = [st["bounds"] for st in stat_k1]
    est = {e: max(memory.case_bytes(levels7, [e], cfg7.precision, None, mesh.devices,
                                    bounds).values())
           for e in ("k1", "inplace")}
    cut = (est["k1"] + est["inplace"]) // 2
    stat_r = build_patch_statics(cfg7, levels7, dev, x_mesh=mesh, capacity=cut)
    print(f"[10c shard] the card's rule on 2 virtual slabs: at the card's capacity "
          f"{stat_k1[0]['engine']} ({stat_k1[0]['engine_why']}); at {cut / 1e9:.3f} GB "
          f"{stat_r[0]['engine']} ({stat_r[0]['engine_why']})", flush=True)
    require(stat_k1[0]["engine"] == "k1" and stat_r[0]["engine"] == "inplace",
            ("row engine on 2 slabs", stat_k1[0]["engine"], stat_r[0]["engine"]))
    del stat_k1
    # the reference is one device's eager loop: a record or replay fault
    # that the graphed one-device and sharded forms share would not show
    # against a graphed one
    one = make_batch_runner_dense(cfg7, params7, levels7, statics7, graphs=False)
    two = make_batch_runner_dense(cfg7, params7, levels7, stat_r, x_mesh=mesh)
    want_ref = one([{**s, "f": s["f"].clone()} for s in state7], 1, 10)
    sh = shard_states(state7, mesh)
    cuda_step.reset_launches()
    sh = two(sh, 1, 10)
    got = cuda_step.executed_launches()
    nbz = sum(s["bouzidi"] is not None for s in stat_r[0]["shards"])
    require(got == {**{k: 0 for k in got}, "stream_collide_inplace_shard": 20,
                    "bouzidi_shard": 10 * nbz}, ("row launches on 2 slabs", got))
    launches["stream_collide_inplace_shard"] = got["stream_collide_inplace_shard"]
    equal = states_equal(gather_states(sh, dev), want_ref)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(dev)
    peak = checks.step_peak_bytes(lambda: two(sh, 11, 1), dev, two.graph_set)
    n_cells = levels7[0].n_cells
    b = slab_bounds(levels7[0].interior[0], 2)
    print(f"[10c shard] the {n_cells / 1e6:.1f}M-cell row on 2 virtual slabs x {b} "
          f"(K5 + K2 sharded, graphed): 10 steps bit-equal to one device's eager "
          f"loop (K1, the card's rule): {equal} | "
          f"launches {dict((k, v) for k, v in got.items() if v)} | one sharded "
          f"coarse step's peak above the live {live / 1e9:.2f} GB, the graphs' "
          f"pool included: {peak / 1e9:.3f} "
          f"GB, {peak / 2 / 1e9:.3f} GB per slab (a slab's rho + vel "
          f"{n_cells / 2 * 16 / 1e9:.3f} GB) | card: {smi}", flush=True)
    require(equal, "63.7M row on 2 slabs against one device")
    del want_ref, sh, one, two, stat_r

    # ---- 10d. devices: 2 with no mesh on this machine ----
    if torch.cuda.device_count() == 1:
        try:
            solve_case(cfg10.with_overrides(devices=2, output_dir="RESULTS_d2"),
                       device="cuda")
            raised = ""
        except RuntimeError as exc:
            raised = str(exc)
        print(f"[10d shard] devices: 2 on one visible card raises: {raised!r}",
              flush=True)
        require("2 CUDA devices, 1 visible" in raised, ("devices: 2", raised))
    print(f"[10 shard] phase {time.time() - t_phase:.1f} s", flush=True)
    return res, launches


# the bench case on the blocks layout (bench.py:67-104 with layout: blocks),
# measured with the JAX package's builder: blocks per level, and its cells
BLOCKS_BENCH = (392, 1000, 1728)


def phase_11(dev, smi, tmp, check_run_outputs, states_equal):
    """Phase 11, the blocks layout and async_depth on the card (module
    docstring)."""
    import numpy as np
    import torch

    from open_ludwig_torch import checkpoint as ckpt
    from open_ludwig_torch import checks
    from open_ludwig_torch.core.state import build_all, hbm_estimate
    from open_ludwig_torch.domain.builder import setup_case
    from open_ludwig_torch.ops import cuda_step, dense_step
    from open_ludwig_torch.ops.stream_collide import stream_collide
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver import (
        _parent_view, make_batch_runner, make_coarse_step, ramp_velocity)
    from open_ludwig_torch.solver_dense import build_patch_statics, init_patch_state
    from open_ludwig_torch.tools import profile_slice

    none = {k: 0 for k in cuda_step.LAUNCHES}
    t_phase = time.time()

    # ---- 11a. the bench case on the blocks layout through the runner ----
    cfg = checks.bench_config(os.path.join(tmp, "blocks"), precision="float32",
                              steps=200, diag_freq=50).with_overrides(layout="blocks")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    live0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_step.reset_launches()
    t0 = time.time()
    res = solve_case(cfg, device="cuda")
    wall = time.time() - t0
    got = cuda_step.executed_launches()
    peak = torch.cuda.max_memory_allocated(dev) - live0
    require(got == none, ("the blocks layout launched a kernel", got))
    check_run_outputs(res, cfg)
    require(np.isfinite(res.final_forces.Cd), ("blocks Cd", res.final_forces.Cd))
    win = res.windows[1:]  # the first interval carries the warm-up
    n_steps = sum(b - a + 1 for a, b, _ in win)
    sec = sum(ms for _, _, ms in win) / 1e3
    ms_step = sec / n_steps * 1e3
    print(f"[11a blocks] bench case, layout blocks, float32: {res.total_cells} cells "
          f"({res.total_cells / 1e6:.3f}M), {res.updates_per_coarse / 1e6:.3f}M site "
          f"updates per coarse step | {n_steps} steps after the first 50 in "
          f"{sec:.3f} s (CUDA events) -> {ms_step:.3f} ms/coarse step, "
          f"{res.updates_per_coarse / ms_step / 1e3:.1f} MLUPS-su, "
          f"{res.total_cells / ms_step / 1e3:.1f} MLUPS-ref | rho_min "
          f"{res.final_stats.rho_min:.4f} | Cd {res.final_forces.Cd:.4f} | run {wall:.1f} s "
          f"(host set-up included) | port kernels launched: none | card: {smi}",
          flush=True)
    # the levels again (host), their statics on the card: the memory estimate
    # and 10 coarse steps profiled after 20 of warm-up
    t0 = time.time()
    _, params, levels = setup_case(cfg)
    states, statics = build_all(cfg, params, levels, dev)
    rows, est, trans = hbm_estimate(levels, statics)
    for geo, state_b, field_b, plan_b, bz_b in rows:
        print(f"[11a blocks] level {geo.level_id}: {geo.dims} block grid, "
              f"{geo.n_blocks} blocks, {geo.n_cells} cells | state {state_b / 1e6:.1f} "
              f"MB, fields {field_b / 1e6:.1f} MB, plan {plan_b / 1e6:.1f} MB (int64), "
              f"bouzidi {bz_b / 1e6:.1f} MB", flush=True)
    print(f"[11a blocks] hbm_report estimate {est / 1e9:.3f} GB (incl. {trans / 1e6:.0f}"
          f" MB step transient) | torch.cuda.max_memory_allocated during the run "
          f"{peak / 1e9:.3f} GB above the {live0 / 1e9:.3f} GB live before it | "
          f"host rebuild {time.time() - t0:.1f} s | card: {smi}", flush=True)
    require(tuple(g.n_blocks for g in levels) == BLOCKS_BENCH
            and res.total_cells == 512 * sum(BLOCKS_BENCH),
            ("blocks bench levels", [g.n_blocks for g in levels], res.total_cells))
    run = make_batch_runner(cfg, params, statics)
    states = run(states, 1, 20)
    # the peak above the live state of one coarse step, and of one sub-step
    # of level 3 (reading level 2 as its parent)
    peak_step = checks.step_peak_bytes(lambda: run(states, 21, 1), dev)
    kw3 = dict(tau=float(params.tau_levels[2]), c_wale=cfg.c_wale,
               nu_sgs_background=cfg.nu_sgs_background,
               inlet_turbulence=cfg.inlet_turbulence_intensity,
               wall_model=cfg.wall_model_enabled,
               sponge_blend=cfg.sponge_blend_distributions,
               use_temporal=cfg.temporal_interpolation, temporal_weight=0.5,
               parent=_parent_view(states[1], states[1]))
    peak_l3 = checks.step_peak_bytes(lambda: stream_collide(
        states[2]["f"], states[2]["vel"], cfg.u_lattice, 7, statics[2], **kw3), dev)
    print(f"[11a blocks] peak allocation above the live state: one coarse step "
          f"{peak_step / 1e9:.3f} GB, one level-3 sub-step {peak_l3 / 1e9:.3f} GB "
          f"({peak_l3 / levels[2].n_cells:.0f} B a cell; its f is 108 B a cell)",
          flush=True)
    prof, states = profile_slice.profile_steps(run, states, 21, 10,
                                               res.updates_per_coarse)
    print(f"[11a blocks] 10 coarse steps after 20 of warm-up, one call each: "
          f"{prof['ms']:.3f} ms/coarse step ({prof['mlups_su']:.1f} MLUPS-su; CUDA "
          f"events) | under torch.profiler: {measured(prof['device_ops'])} CUDA "
          f"device operations (launches) per coarse step, device busy "
          f"{measured(prof['busy_share'], '.1%')} of {prof['window_ms'] / 10:.3f} ms "
          f"per profiled step | card: {smi}",
          flush=True)
    print("[11a blocks] most launched: " + "; ".join(
        f"{t['per_call']:.0f} x {t['name']}" for t in prof["top"]), flush=True)
    require(prof["port_kernels"] == 0 and prof["device_ops"] > 0
            and all(bool(torch.isfinite(st["rho"]).all()) for st in states),
            ("profiled blocks steps", prof["port_kernels"], prof["device_ops"]))
    del states, statics, run

    # ---- 11b. one single-level sphere on both layouts ----
    t0 = time.time()
    d = os.path.join(tmp, "layouts")
    cfg1 = checks.bench_config(d, surface_resolution=10, num_levels=1, steps=6,
                               ramp_steps=3, output_freq=100, diag_freq=100,
                               wake_enabled=False, boundary_method="bounce_back",
                               inlet_turbulence=0.02, precision="float32")
    mesh1, params1, levels1 = setup_case(cfg1)
    bstates, bstatics = build_all(cfg1, params1, levels1, dev)
    step_b = make_coarse_step(cfg1, params1, bstatics)
    patch = checks.case_levels(cfg1)[2][0]
    pstatic = build_patch_statics(cfg1, [patch], dev)[0]
    kw1 = dict(c_wale=cfg1.c_wale, nu_sgs_background=cfg1.nu_sgs_background,
               inlet_turbulence=cfg1.inlet_turbulence_intensity,
               wall_model=cfg1.wall_model_enabled,
               sponge_blend=cfg1.sponge_blend_distributions)
    plain = init_patch_state(patch, "float32", dev)
    k1 = init_patch_state(patch, "float32", dev)
    for t in range(1, 5):
        bstates = step_b(bstates, t)
        u = ramp_velocity(t, cfg1.u_lattice, cfg1.ramp_steps)
        f, r, v = dense_step.dense_stream_collide(plain["f"], plain["vel"], u, t,
                                                  pstatic, patch, **kw1)
        plain = {"f": f, "rho": r, "vel": v}
        f, r, v = cuda_step.stream_collide(k1["f"], k1["vel"], u, t, pstatic,
                                           patch, **kw1)
        k1 = {"f": f, "rho": r, "vel": v}
    geo = levels1[0]
    lf = torch.arange(512, device=dev)
    coords = torch.as_tensor(geo.coords, dtype=torch.long, device=dev)
    gx = coords[:, 0, None] * 8 + (lf % 8)[None, :]
    gy = coords[:, 1, None] * 8 + ((lf // 8) % 8)[None, :]
    gz = coords[:, 2, None] * 8 + (lf // 64)[None, :]
    X, Y, Z = patch.interior
    diffs = {}
    for key in ("f", "vel"):
        blk = bstates[0][key]
        dense = torch.zeros(blk.shape[:-2] + tuple(8 * n for n in geo.dims),
                            dtype=blk.dtype, device=dev)
        dense[:, gx, gy, gz] = blk
        dense = dense[..., :X, :Y, :Z]
        diffs[key] = (float((dense - plain[key]).abs().max()),
                      float((dense - k1[key]).abs().max()))
    print(f"[11b layouts] single-level sphere {patch.interior} ({geo.n_blocks} blocks),"
          f" 4 coarse steps from rest on the card: blocks vs the patch layout's plain "
          f"step max |diff| f {diffs['f'][0]:.2e}, vel {diffs['vel'][0]:.2e} (tol 5e-6)"
          f" | blocks vs K1: f {diffs['f'][1]:.2e}, vel {diffs['vel'][1]:.2e} | "
          f"{time.time() - t0:.1f} s", flush=True)
    require(diffs["f"][0] < 5e-6 and diffs["vel"][0] < 5e-6, ("layouts", diffs))
    del bstates, bstatics, plain, k1, pstatic

    # ---- 11c. async_depth on the main path ----
    t0 = time.time()
    cfg3 = checks.bench_config(os.path.join(tmp, "async"), steps=20, diag_freq=10)
    finals = {}
    for depth in (3, 0):
        c = cfg3.with_overrides(async_depth=depth, checkpoint_freq=20,
                                output_dir=f"RESULTS_AD{depth}")
        solve_case(c, device="cuda")
        with open(os.path.join(c.output_path, "convergence.csv")) as fh:
            steps = [int(r.split(",", 1)[0]) for r in fh.readlines()[1:]]
        require(steps == [10, 20], ("async_depth CSV steps", depth, steps))
        finals[depth] = ckpt.load_checkpoint(
            os.path.join(c.output_path, "checkpoints", "ckpt_00000020.npz"),
            cfg3.precision, dev)[1]
    equal = states_equal(finals[3], finals[0])
    print(f"[11c async] bench case (patch, bf16), 20 coarse steps with async_depth 3 "
          f"(calls of 3, 3, 3, 1 per batch of 10) and 0 (one call): final states "
          f"bit-equal: {equal}, CSV steps [10, 20] in both | {time.time() - t0:.1f} s",
          flush=True)
    require(equal, "async_depth 3 against 0")
    print(f"[11 blocks] phase {time.time() - t_phase:.1f} s", flush=True)


# the shipped cases of CASES/ that phase 12 runs: (label, case, half model)
SHIPPED = (("cube", "cube", False), ("wing_5deg", "wing_5deg", False),
           ("sphere_re10m", "sphere_re10m", False),
           ("half_re1m", "sphere_re1m", True))


LONG_STEPS = 600  # coarse steps of phase 12's long-horizon check


def phase_12(dev, smi, tmp, check_run_outputs, mem_row):
    """Phase 12, the shipped cases on the card (module docstring)."""
    import torch

    from open_ludwig_torch import bench, checks
    from open_ludwig_torch.config import load_case_config
    from open_ludwig_torch.ops import cuda_step, storage
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver_dense import (
        build_patch_statics, hbm_total_patches, init_patch_state,
        make_batch_runner_dense)
    from open_ludwig_torch.tools import profile_slice

    none = {k: 0 for k in cuda_step.LAUNCHES}
    t_phase = time.time()
    for label, name, half in SHIPPED:
        t0 = time.time()
        full = load_case_config(os.path.join(checks.CASES_DIR, name)).steps
        cfg = checks.shipped_config(os.path.join(tmp, "shipped", label), name,
                                    symmetric=half)
        _, params, levels = checks.case_levels(cfg)
        statics = build_patch_statics(cfg, levels, dev)
        bf16 = storage.f_dtype(cfg.precision) == torch.bfloat16
        per_step = bench.batch_launches(statics, 1, False)
        est = hbm_total_patches(levels, statics, cfg.precision, dev)
        tag = f"[12 {label}]"
        print(f"{tag} CASES/{name}{' as the half model (y = 0 mirror)' if half else ''}"
              f", cut to {cfg.steps} of its {full} coarse steps, {cfg.precision}: "
              + ", ".join(f"L{p.level_id} {tuple(p.interior)} {st['engine']}"
                          for p, st in zip(levels, statics))
              + f" | Bouzidi box {tuple(statics[-1]['bouzidi']['dim'])} at "
              f"{tuple(statics[-1]['bouzidi']['lo'])} | launches a coarse step "
              f"{per_step}", flush=True)
        base = bench.memory_start(dev)
        cuda_step.reset_launches()
        res = solve_case(cfg, device="cuda")
        got = cuda_step.executed_launches()
        mem = bench.memory_fields(dev, base, est)
        require(got == {**none, **{k: v * cfg.steps for k, v in per_step.items()}},
                (label, "launches", got, per_step))
        check_run_outputs(res, cfg)
        mem_row(f"12 {label} solve_case", mem)
        require(res.final_stats.rho_max < 1.5, (label, "rho_max", res.final_stats))
        win = res.windows[1:]  # the first interval carries the warm-up
        n_steps = sum(b - a + 1 for a, b, _ in win)
        ms = sum(t for _, _, t in win) / n_steps
        run = make_batch_runner_dense(cfg, params, levels, statics)
        states = run([init_patch_state(p, cfg.precision, dev) for p in levels], 1, 20)
        prof, states = profile_slice.profile_steps(run, states, 21, 10,
                                                   res.updates_per_coarse)
        require(all(bool(torch.isfinite(st["rho"]).all()) for st in states),
                (label, "profiled states"))
        del run, states
        print(f"{tag} {res.total_cells / 1e6:.3f}M cells, {res.updates_per_coarse / 1e6:.3f}"
              f"M site updates per coarse step | {n_steps} steps after the first 50: "
              f"{ms:.3f} ms/coarse step (CUDA events), "
              f"{res.updates_per_coarse / ms / 1e3:.1f} MLUPS-su, "
              f"{res.total_cells / ms / 1e3:.1f} MLUPS-ref | profiled 10 steps: "
              f"{prof['ms']:.3f} ms, {measured(prof['device_ops'])} CUDA device "
              f"operations per coarse step, device busy "
              f"{measured(prof['busy_share'], '.1%')} | peak allocated "
              f"{mem['peak_gb']:.3f} GB (hbm_report estimate "
              f"{est / 1e9:.3f} GB, estimate / peak {mem['estimate_over_peak']:.3f}) "
              "| rho "
              f"{res.final_stats.rho_min:.4f}..{res.final_stats.rho_max:.4f}, Cd "
              f"{res.final_forces.Cd:.4f} | card: {smi}", flush=True)

        # each level's kernel against its plain version at this case's shapes
        kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                  inlet_turbulence=cfg.inlet_turbulence_intensity,
                  wall_model=cfg.wall_model_enabled,
                  sponge_blend=cfg.sponge_blend_distributions)
        for lvl, (p, st) in enumerate(zip(levels, statics)):
            seed, where = 50 + lvl, f"L{p.level_id} {tuple(p.interior)}"
            if lvl == len(levels) - 1:
                plan = st["bouzidi"]
                r = checks.check_bouzidi(p, plan, bf16, seed, dev, reps=10, plain_reps=2)
                print(f"{tag} K2 on {where}: box {tuple(plan['dim'])} at "
                      f"{tuple(plan['lo'])}, {r['links']} links, err "
                      f"{r['max_abs_err']:.2e} (tol {r['tol']:.0e}) | {r['ms']:.5f} ms "
                      f"(graph {r['graph_ms']:.5f}), bound {r['bound_ms']:.6f} ms, plain "
                      f"{r['plain_ms']:.3f} ms", flush=True)
                require(r["changed"] > 0 and r["max_abs_err"] < r["tol"]
                        and r["peak_bytes"] == 0, (label, "K2", r))
                r = checks.check_fused_pair(p, checks.with_sponge_ramp(st), plan, bf16,
                                            seed, kw, dev, reps=5, plain_reps=1)
                u = r["unfused"]
                print(f"{tag} K3 + K2 on {where}: vs plain err {r['max_abs_err']:.2e} "
                      f"(tol {r['tol']:.0e}) | vs K1 -> K2 -> K1: max "
                      f"{u['max_abs_err']:.2e}, {100 * u['diff_frac']:.3f}% stored f "
                      f"differ | K3 {r['ms']:.4f} ms per pair (bound {r['bound_ms']:.4f}),"
                      f" unfused {r['unfused_ms']:.4f}, plain {r['plain_ms']:.3f}",
                      flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"]
                        and checks.within_k3_tol(u, bf16), (label, "K3", r["err"], u))
            elif st["engine"] == "flat":
                r = checks.check_flat(p, st, bf16, seed, kw, dev, reps=5, plain_reps=1)
                print(f"{tag} K4 on {where}: vs plain err {r['max_abs_err']:.2e} (tol "
                      f"{r['tol']:.0e}), vs K1 {100 * r['k1']['diff_frac']:.4f}% stored f"
                      f" differ | {r['ms']:.4f} ms (graph {r['graph_ms']:.4f}), bound "
                      f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f}", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"]
                        and r["k1"]["diff_frac"] == 0, (label, "K4", r["err"]))
            else:
                r = checks.check_stream_collide(p, checks.with_sponge_ramp(st), bf16,
                                                seed, kw, dev, reps=5, plain_reps=1)
                print(f"{tag} K1 on {where}: vs plain err {r['max_abs_err']:.2e} (tol "
                      f"{r['tol']:.0e}) | {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, "
                      f"plain {r['plain_ms']:.3f}", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"], (label, "K1", r["err"]))
        del statics, levels
        torch.cuda.empty_cache()
        print(f"{tag} {time.time() - t0:.1f} s", flush=True)
    # the validation regime's case (Re~1M, float32, wall model on) over a
    # long horizon from one perturbed state: K3 pairs twice and unfused
    # K1 -> K2 -> K1, which must stay bit-equal step after step
    from open_ludwig_torch.tools.validate_spheres import make_case

    t0 = time.time()
    cfg = load_case_config(make_case("1M", os.path.join(tmp, "shipped", "long")))
    _, params, levels = checks.case_levels(cfg)
    statics = build_patch_statics(cfg, levels, dev)
    gen = torch.Generator(device=dev)
    finals = []
    for fuse2 in (True, True, False):
        gen.manual_seed(77)
        states = [{"f": init_patch_state(p, cfg.precision, dev)["f"]
                   * (1 + 0.01 * torch.randn((27,) + tuple(p.interior), generator=gen,
                                             device=dev)),
                   "rho": torch.ones(tuple(p.interior), device=dev),
                   "vel": torch.zeros((3,) + tuple(p.interior), device=dev)}
                  for p in levels]
        run = make_batch_runner_dense(cfg, params, levels, statics, fuse2=fuse2)
        finals.append(run(states, 2001, LONG_STEPS))
    torch.cuda.synchronize(dev)

    def equal(a, b):
        return all(torch.equal(x[k], y[k]) for x, y in zip(a, b)
                   for k in ("f", "rho", "vel"))
    same, unfused = equal(finals[0], finals[1]), equal(finals[0], finals[2])
    rho = finals[0][-1]["rho"]
    print(f"[12 long] the Re~1M validation case (float32, wall model), "
          f"{LONG_STEPS} coarse steps past the ramp from one perturbed state: "
          f"K3 pairs twice bit-equal {same}, equal to K1 -> K2 -> K1 {unfused} | "
          f"finest rho {float(rho.min()):.4f}..{float(rho.max()):.4f} | "
          f"{time.time() - t0:.1f} s", flush=True)
    require(same and unfused, ("long horizon", same, unfused))
    del finals, states, statics
    print(f"[12 shipped] phase {time.time() - t_phase:.1f} s", flush=True)


# phase 13's batches: (t0, n) calls of the batch runner from t = 1 across
# the ramp (RAMP13 coarse steps) and past it, odd and even n
RAMP13 = 20
CALLS13 = ((1, 7), (8, 12), (20, 3), (23, 18))


def phase_13(dev, smi, tmp, random_states, states_equal):
    """Phase 13, the batch as one program: graph replay against the eager
    loop (module docstring)."""
    import numpy as np
    import torch

    from open_ludwig_torch import checks, solver
    from open_ludwig_torch.core.state import build_all
    from open_ludwig_torch.domain.builder import setup_case
    from open_ludwig_torch.ops import cuda_step
    from open_ludwig_torch.parallel.patch_shard import XMesh, gather_states, shard_states
    from open_ludwig_torch.runner import solve_case
    from open_ludwig_torch.solver_dense import build_patch_statics, make_batch_runner_dense
    from open_ludwig_torch.tools import profile_slice

    TURNS13 = profile_slice.TURNS
    t_phase = time.time()
    steps13 = sum(n for _, n in CALLS13)

    def compare(tag, make, fresh, updates, turns: bool, gather=lambda s: s,
                prof_steps=5):
        """The eager loop and the graphed runner from equal states over
        CALLS13: bit-equal states, equal kernel launches executed (the
        graphed run's from its replays); then, with `turns`, both timed in
        turns (`profile_slice.turns`)."""
        t0 = time.time()
        runs = {"eager": make(False), "graph": make(True)}
        got = {}
        for mode in ("eager", "graph"):
            st = fresh()
            cuda_step.reset_launches()
            for a, n in CALLS13:
                st = runs[mode](st, a, n)
            torch.cuda.synchronize(dev)
            got[mode] = (gather(st), cuda_step.executed_launches(),
                         sum(cuda_step.LAUNCHES.values()))
            del st
        equal = states_equal(got["eager"][0], got["graph"][0])
        ex = {k: v for k, v in got["eager"][1].items() if v}
        gx = {k: v for k, v in got["graph"][1].items() if v}
        gset = runs["graph"].graph_set
        replays = gset.replays
        print(f"{tag} {steps13} coarse steps in calls {CALLS13} (ramp {RAMP13}, inlet "
              f"noise 0.02): graph replay bit-equal to the eager loop: {equal} | "
              f"launches executed, eager {ex} / graph {gx} ({got['graph'][2]} issued "
              f"by the wrappers at warm-up and capture, {replays} replays) | "
              f"{gset.report()} | {time.time() - t0:.1f} s", flush=True)
        require(equal, (tag, "graph replay against the eager loop"))
        require(ex == gx and replays > len(CALLS13) and len(gset.graphs) > 0
                and (not ex or got["graph"][2] < sum(ex.values())),
                (tag, "launch accounting", ex, gx, got["graph"][2], replays))
        del got
        if not turns:
            return None
        t1 = time.time()
        res = profile_slice.turns(runs, fresh, 1, 20, updates, dev, TURNS13,
                                  prof_steps=prof_steps)

        def fmt(key, scale=1.0, spec=".3f"):
            return "/".join(measured(r[key], spec, scale)
                            for m in TURNS13[:2] for r in res[m])

        print(f"{tag} in turns graph, eager, eager, graph (printed graph, graph / "
              f"eager, eager; 20 coarse steps a call after 4, then {prof_steps} "
              f"profiled): ms a coarse step "
              f"{fmt('ms')} | CUDA device "
              f"operations a coarse step {fmt('device_ops', spec='.1f')} | device "
              f"busy % {fmt('busy_share', 100, '.1f')} | peak allocated above the "
              f"live state GB {fmt('peak_bytes', 1e-9)} (live "
              f"{res['graph'][0]['live_bytes'] / 1e9:.3f} GB) | MLUPS-su "
              f"{fmt('mlups_su', spec='.0f')} | {time.time() - t1:.1f} s | card: "
              f"{smi}", flush=True)
        del runs
        torch.cuda.empty_cache()
        return res

    out = {}
    # ---- 13a. the bench case, and 13d. the bench on 2 virtual slabs ----
    for prec in ("bfloat16", "float32"):
        bf = prec == "bfloat16"
        cfg = checks.bench_config(os.path.join(tmp, f"g13_{prec}"), precision=prec,
                                  ramp_steps=RAMP13).with_overrides(
                                      inlet_turbulence_intensity=0.02)
        t0 = time.time()
        _, params, levels = checks.case_levels(cfg)
        statics = build_patch_statics(cfg, levels, dev)
        print(f"[13a bench {prec}] case built in {time.time() - t0:.1f} s", flush=True)
        upd = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)
        out[("bench", prec)] = compare(
            f"[13a bench {prec}]",
            lambda g: make_batch_runner_dense(cfg, params, levels, statics, graphs=g),
            lambda: random_states(levels, prec, 53), upd, turns=bf)
        mesh = XMesh([dev] * 2)
        stat2 = build_patch_statics(cfg, levels, dev, x_mesh=mesh)
        out[("mesh2", prec)] = compare(
            f"[13d bench on 2 virtual slabs {prec}]",
            lambda g: make_batch_runner_dense(cfg, params, levels, stat2,
                                              x_mesh=mesh, graphs=g),
            lambda: shard_states(random_states(levels, prec, 53), mesh), upd,
            turns=bf, gather=lambda s: gather_states(s, dev))
        del statics, stat2
    # the runner end to end: forces.csv rows of both modes identical
    t0 = time.time()
    cfg = checks.bench_config(os.path.join(tmp, "g13_run"), steps=40,
                              ramp_steps=RAMP13, diag_freq=10).with_overrides(
                                  inlet_turbulence_intensity=0.02)
    rows, res = {}, {}
    for mode in ("graph", "eager"):
        c = cfg.with_overrides(output_dir=f"RESULTS_{mode}")
        cuda_step.reset_launches()
        res[mode] = solve_case(c, device="cuda", graphs=mode == "graph")
        with open(os.path.join(c.output_path, "forces.csv")) as fh:
            rows[mode] = fh.read().splitlines()
    same = rows["graph"] == rows["eager"] and len(rows["graph"]) == 5
    print(f"[13a bench run] solve_case 40 steps (ramp {RAMP13}), forces every 10: "
          f"forces.csv rows of the graphed and the eager runner identical: {same} "
          f"({len(rows['graph']) - 1} rows) | graphed: {res['graph'].graph_report} | "
          f"{time.time() - t0:.1f} s", flush=True)
    require(same and res["graph"].final_forces.Cd == res["eager"].final_forces.Cd,
            ("solve_case graph against eager", rows))

    # ---- 13b. CASES/cube: 4 levels, eight K1 sub-steps of level 4 a step,
    # and four K3 pairs under fuse2=True ----
    for prec in ("float32", "bfloat16"):
        cfg = checks.shipped_config(os.path.join(tmp, f"g13_cube_{prec}"), "cube"
                                    ).with_overrides(precision=prec, ramp_steps=RAMP13,
                                                     inlet_turbulence_intensity=0.02)
        t0 = time.time()
        _, params, levels = checks.case_levels(cfg)
        statics = build_patch_statics(cfg, levels, dev)
        print(f"[13b cube {prec}] case built in {time.time() - t0:.1f} s", flush=True)
        require(len(levels) == 4, ("cube levels", len(levels)))
        upd = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)
        out[("cube", prec)] = compare(
            f"[13b cube {prec}]",
            lambda g: make_batch_runner_dense(cfg, params, levels, statics, graphs=g),
            lambda: random_states(levels, prec, 59), upd, turns=prec == "float32")
        # the JAX package's schedule on 4 levels: level 4's sub-step pairs
        # on K3 (fuse2=True), graph against eager
        compare(f"[13b cube fused {prec}]",
                lambda g: make_batch_runner_dense(cfg, params, levels, statics,
                                                  graphs=g, fuse2=True),
                lambda: random_states(levels, prec, 59), upd, turns=False)
        del statics

    # ---- 13c. the 10.8M-cell single level: the pair runner (fuse2=True) ----
    t0 = time.time()
    cfg = checks.bench_config(os.path.join(tmp, "g13_single"), surface_resolution=25,
                              num_levels=1, ramp_steps=RAMP13)
    _, params, levels = checks.case_levels(cfg)
    print(f"[13c 10.8M single level] case built in {time.time() - t0:.1f} s",
          flush=True)
    for prec in ("bfloat16", "float32"):
        c = cfg.with_overrides(precision=prec, inlet_turbulence_intensity=0.02)
        statics = build_patch_statics(c, levels, dev)
        out[("single", prec)] = compare(
            f"[13c 10.8M single level, K3 pairs {prec}]",
            lambda g: make_batch_runner_dense(c, params, levels, statics, graphs=g,
                                              fuse2=True),
            lambda: random_states(levels, prec, 61), levels[0].n_cells,
            turns=prec == "bfloat16", prof_steps=20)
        # K5 in place on the same level: its edge copy reads what the
        # previous replay wrote into the one f buffer
        k5 = [{**s, "engine": "inplace", "engine_why": "forced"} for s in statics]
        compare(f"[13c 10.8M single level, K5 forced {prec}]",
                lambda g: make_batch_runner_dense(c, params, levels, k5, graphs=g),
                lambda: random_states(levels, prec, 61), levels[0].n_cells,
                turns=False)
        del statics, k5
    torch.cuda.empty_cache()

    # ---- 13e. layout: blocks (float32, as the JAX package runs it) ----
    t0 = time.time()
    cfg = checks.bench_config(os.path.join(tmp, "g13_blocks"), precision="float32",
                              ramp_steps=RAMP13).with_overrides(
                                  layout="blocks", inlet_turbulence_intensity=0.02)
    _, params, levels = setup_case(cfg)
    base, statics = build_all(cfg, params, levels, dev)
    gen = torch.Generator(device=dev).manual_seed(67)
    for st in base:
        st["f"] = st["f"] * (1 + 0.03 * torch.randn(st["f"].shape, generator=gen,
                                                    device=dev))
    print(f"[13e blocks] bench case on the blocks layout rebuilt in "
          f"{time.time() - t0:.1f} s", flush=True)
    out[("blocks", "float32")] = compare(
        "[13e blocks float32]",
        lambda g: solver.make_batch_runner(cfg, params, statics, graphs=g),
        lambda: [{k: v.clone() for k, v in st.items()} for st in base],
        sum(g.n_cells * 2 ** (g.level_id - 1) for g in levels), turns=True)
    del base, statics
    torch.cuda.empty_cache()
    print(f"[13 graphs] phase {time.time() - t_phase:.1f} s", flush=True)
    return out


BENCH_TOL14 = 0.2  # the headline's median against phase 13's graphed turns
ROW_KEYS14 = ("res", "cells", "label", "mlups", "mlups_min", "mlups_max", "windows",
              "engine", "peak_gb", "reserved_gb", "context_gb", "reserve_gb",
              "estimate_gb", "estimate_over_peak", "error")


def phase_14(smi, tmp, bench13, per_step, mem_row):
    """Phase 14, the bench entry point (module docstring).  `bench13` is
    phase 13's bf16 bench turns (`profile_slice.turns`), `per_step` the
    launches a coarse step of the bench case executes."""
    import math

    import torch

    from open_ludwig_torch import bench

    t_phase = time.time()
    head = bench.headline("cuda")  # raises on a capture inside a timed window
    print("[14 bench] headline: " + json.dumps(head) + f" | card: {smi}", flush=True)
    nums = [head[k] for k in ("value", "value_su", "value_ref", "value_su_min",
                              "value_su_max", "ms_per_coarse_step")] + head["build_ms"]
    require(all(math.isfinite(v) and v > 0 for v in nums)
            and head["builds"] == len(head["build_ms"]) == bench.HEADLINE_BUILDS
            and head["value_su_min"] <= head["value_su"] <= head["value_su_max"]
            and head["value"] == head["value_su"] and "vs_baseline" not in head,
            ("headline values", nums))
    require(head["launches_per_coarse_step"] == per_step
            and head["engines"] == ["K4", "K1", "K1 + K2"],
            ("headline launches per coarse step", head["launches_per_coarse_step"],
             head["engines"]))
    mem_row("14 headline (largest build)", head)
    turns13 = [r["ms"] for r in bench13["graph"]]
    ms = head["ms_per_coarse_step"]
    print(f"[14 bench] median {ms:.4f} ms per coarse step over {head['builds']} "
          "builds (" + ", ".join(f"{t:.4f}" for t in head["build_ms"])
          + ") against phase 13's graphed bench turns "
          + ", ".join(f"{t:.4f}" for t in turns13)
          + f" ms (within {100 * BENCH_TOL14:.0f}% required) | card: {smi}",
          flush=True)
    require((1 - BENCH_TOL14) * min(turns13) <= ms <= (1 + BENCH_TOL14) * max(turns13),
            ("headline against phase 13", ms, turns13))
    path = os.path.join(tmp, "bench_sweep.json")
    live = torch.cuda.memory_allocated()
    rows = bench.sweep((12,), "cuda", path)
    with open(path) as fh:
        doc = json.load(fh)
    row = rows[0]
    print(f"[14 bench] sweep row: {json.dumps(row)} | file device {doc['device']!r} "
          f"| allocated before the row {live / 1e9:.3f} GB", flush=True)
    mem_row("14 sweep row res 12", row)
    require(len(rows) == 1 and doc["rows"] == rows and doc["device"] == smi
            and tuple(row) == ROW_KEYS14
            and row["error"] is None and row["cells"] == 1605632
            and row["engine"] == "K1 + K2" and row["peak_gb"] > 0
            and row["estimate_over_peak"] >= 1.0
            and math.isfinite(row["mlups"])
            and row["mlups_min"] <= row["mlups"] <= row["mlups_max"],
            ("sweep row", row))
    print(f"[14 bench] phase {time.time() - t_phase:.1f} s", flush=True)


GHOST_CALLS15 = ((1, 4), (5, 3))  # phase 15's batches of the Re10M runner


def ghost_launches(engines, temporal: bool, steps: int, seeds: int = 1) -> dict:
    """The ghost-plane kernels' launches (`ops.ghost_planes.LAUNCHES`) of
    `steps` coarse steps of a case whose levels run `engines`, its carried
    slabs seeded `seeds` times: a child build a parent sub-step (2^(l-1)
    a coarse step under level l), one fused launch under an A -> B parent,
    and under a K5 parent one extraction and one planes launch, with the
    temporal blend one more extraction at each seeding."""
    out = {"ghost_extract": 0, "ghost_planes": 0, "ghost_build": 0}
    for lvl, eng in enumerate(engines[:-1]):
        builds = steps * 2 ** lvl
        if eng == "inplace":
            out["ghost_extract"] += builds + seeds * bool(temporal)
            out["ghost_planes"] += builds
        else:
            out["ghost_build"] += builds
    return out


def phase_15(dev, smi, tmp):
    """Phase 15, the ghost planes' kernels (module docstring).  Returns the
    checks by (case, child level index, temporal)."""
    import torch

    from open_ludwig_torch import checks, spans
    from open_ludwig_torch import lattice as lat
    from open_ludwig_torch.ops import cuda_step, ghost_planes
    from open_ludwig_torch.ops.dense_step import build_iface_mm_plan, iface_mm_plan_to
    from open_ludwig_torch.solver_dense import build_patch_statics, make_batch_runner_dense

    t_phase = time.time()
    keys = set(cuda_step.LAUNCHES)
    cfg = checks.shipped_config(os.path.join(tmp, "ghost", "re10m"), "sphere_re10m")
    _, params, levels = checks.case_levels(cfg)
    statics = build_patch_statics(cfg, levels, dev)
    bcfg, _, _, blevels = checks.bench_case(os.path.join(tmp, "ghost", "bench"))
    bstatics = build_patch_statics(bcfg, blevels, dev)
    out = {}
    for label, lv, st, bf16 in (("Re10M", levels, statics, False),
                                ("bench", blevels, bstatics, True)):
        for li in range(1, len(lv)):
            child, parent = lv[li], lv[li - 1]
            for temporal in (True, False):
                r = checks.check_ghost_kernels(child, parent, st[li]["iface_mm"], bf16,
                                               temporal, seed=90 + li, device=dev)
                out[(label, li, temporal)] = r
                ulps = ("" if r["max_ulps"] is None else
                        f", bf16 g planes the f32 ones rounded {r['bf16_is_cast']}, "
                        f"{100 * r['bf16_diff_frac']:.4f}% differ, {r['raw_ulps']:.1f} "
                        f"ulp apart at most, {r['max_ulps']:.2f} beyond the f32 planes'")
                carry = ("" if r["carry"] is None else
                         f" | the carry's copy {r['carry']['ms']:.5f} ms, bound "
                         f"{r['carry']['bound_ms']:.5f} ms ({r['carry']['bytes'] / 1e6:.2f} MB)")
                fz = r["fused"]
                fused = (f" | the fused build (one launch) bit-equal {r['fused_equal']}, "
                         f"{fz['ms']:.5f} ms, bound {fz['bound_ms']:.5f} ms "
                         f"({fz['bytes'] / 1e6:.2f} MB), plain {fz['plain_ms']:.5f} ms")
                print(f"[15 ghost] {label} L{child.level_id} {tuple(child.interior)} from "
                      f"L{parent.level_id} {'bf16' if bf16 else 'f32 '} "
                      f"{'temporal' if temporal else 'frozen  '}: {r['faces']} faces in "
                      f"{r['groups']} groups | slabs bit-equal {r['slabs_equal']} | f32 "
                      f"planes {r['max_abs_err']:.2e} (tol {r['tol']:.0e}){ulps} | from "
                      f"graphs, a build (extraction and planes) {r['ms']:.5f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bytes'] / 1e6:.2f} MB), plain "
                      f"{r['plain_ms']:.5f} ms; the extraction {r['extract']['ms']:.5f} ms, "
                      f"bound {r['extract']['bound_ms']:.5f}; the planes "
                      f"{r['planes']['ms']:.5f} ms, bound {r['planes']['bound_ms']:.5f}"
                      f"{carry}{fused} | card: {smi}", flush=True)
                require(r["slabs_equal"] and r["max_abs_err"] < r["tol"] and r["fused_equal"]
                        and (not bf16 or (r["bf16_is_cast"] and r["max_ulps"] <= 1.0)),
                        ("ghost kernels", label, li, temporal, r))
    # the geometries no shipped case has (`checks.GHOST_GEOMS`: a group of
    # one face, two groups, the clamp, an offset parent)
    err = ulps = 0.0
    for name in checks.GHOST_GEOMS:
        parent, child = checks.ghost_levels(name)
        plan = iface_mm_plan_to(build_iface_mm_plan(child, parent), dev)
        for bf16 in (False, True):
            for temporal in (True, False):
                r = checks.check_ghost_kernels(child, parent, plan, bf16, temporal,
                                               seed=97, device=dev, reps=1)
                require(r["slabs_equal"] and r["max_abs_err"] < r["tol"] and r["fused_equal"]
                        and (not bf16 or (r["bf16_is_cast"] and r["max_ulps"] <= 1.0)),
                        ("ghost kernels", name, bf16, temporal, r))
                err = max(err, r["max_abs_err"])
                ulps = max(ulps, r["max_ulps"] or 0.0)
    print(f"[15 ghost] {', '.join(checks.GHOST_GEOMS)} (f32 and bf16, temporal and "
          f"frozen): slabs bit-equal, f32 planes at most {err:.2e}, bf16 planes at most "
          f"{ulps:.2f} ulp beyond the f32 planes', the fused build's planes bit-equal",
          flush=True)
    # the Re10M batch graphed against the eager loop, both on the kernels
    gen = torch.Generator(device=dev)
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=dev).view(27, 1, 1, 1)

    def start():
        gen.manual_seed(93)
        return [{"f": w * (1 + 0.01 * torch.randn((27,) + tuple(p.interior), generator=gen,
                                                  device=dev)),
                 "rho": 1 + 0.005 * torch.randn(tuple(p.interior), generator=gen, device=dev),
                 "vel": 0.01 * torch.randn((3,) + tuple(p.interior), generator=gen,
                                           device=dev)}
                for p in levels]

    # level 1 on K4 (the card's rule), then on K5 (a capacity of one byte):
    # the child of a K4 parent builds fused, of a K5 parent on two kernels
    k5_statics = build_patch_statics(cfg, levels, dev, capacity=1)
    finals, two_kernels = [], None
    for label, sts, want_count in (("K4 parent", statics, "planes.fused"),
                                   ("K5 parent", k5_statics, "planes.kernel")):
        engines = [st["engine"] for st in sts]
        before = spans.snapshot()
        ghost_planes.reset_launches()
        ends, replays = [], 0
        for graphs in (True, False):
            run = make_batch_runner_dense(cfg, params, levels, sts, graphs=graphs)
            states = start()
            for t0, n in GHOST_CALLS15:
                states = run(states, t0, n)
            ends.append(states)
            replays += run.graph_set.replays if run.graph_set is not None else 0
        torch.cuda.synchronize(dev)
        counts = spans.since(before)["counts"]
        got = ghost_planes.executed_launches()
        # both runners: each seeds its carried slabs once, then runs every step
        want = ghost_launches(engines, cfg.temporal_interpolation,
                              2 * sum(n for _, n in GHOST_CALLS15), 2)
        equal = all(torch.equal(a[k], b[k]) for a, b in zip(*ends)
                    for k in ("f", "rho", "vel"))
        builds = counts.get(want_count, 0)
        finals.append(ends[0])
        if label == "K5 parent":
            two_kernels = got
        print(f"[15 ghost] Re10M batches {GHOST_CALLS15}, engines {engines}, graphed "
              f"against the eager loop: bit-equal {equal}, {replays} replays | child "
              f"builds issued fused {counts.get('planes.fused', 0)}, on two kernels "
              f"{counts.get('planes.kernel', 0)}, plain {counts.get('planes.plain', 0)} | "
              f"executed launches {got} (want {want}) | launch counters "
              f"{sorted(cuda_step.LAUNCHES)}", flush=True)
        require(equal and replays > 0 and builds > 0 and "planes.plain" not in counts
                and got == want and set(cuda_step.LAUNCHES) == keys
                and engines[0] == ("inplace" if label == "K5 parent" else "flat"),
                ("ghost batches", label, equal, replays, counts, got, want,
                 sorted(cuda_step.LAUNCHES)))
    # K5 steps as K4 does, bit for bit: the fused builds equal the two kernels'
    same = all(torch.equal(a[k], b[k]) for a, b in zip(*finals) for k in ("f", "rho", "vel"))
    print(f"[15 ghost] Re10M under a K4 parent (fused builds) and a K5 parent (two "
          f"kernels under it): bit-equal {same} | phase {time.time() - t_phase:.1f} s",
          flush=True)
    require(same, ("fused against two-kernel builds", same))
    return out, two_kernels


FORCE_SUMS16 = ("Cd", "Cl", "Cs", "Fx_pressure", "Fy_pressure", "Fz_pressure",
                "Fx_viscous", "Fy_viscous", "Fz_viscous", "Mx", "My", "Mz")


def phase_16(dev, smi) -> dict:
    """Phase 16, a force sample as one graph replay (module docstring).
    Returns its figures for the last JSON line."""
    import statistics

    import numpy as np
    import torch

    from lbm_bench import harness
    from open_ludwig_torch import spans
    from open_ludwig_torch.ops import forces

    t_phase = time.time()
    files = harness.cell_files(harness.load_spec(), "sphere_re10m.samples")
    prog = harness.Program(files["case_dir"], files["traffic"], dev, say=lambda m: None)
    states, t = prog.warm(2 ** 31 + 16), prog.t0
    for _ in range(3):  # eager, capture, replay: the runner's own buffers
        states = prog.run(states, t, prog.n_call)
        t += prog.n_call
    torch.cuda.synchronize(dev)
    ctx, fine = prog.ctx, states[-1]

    def eager(st):
        return forces.force_result(forces.eager_sums(st["rho"], st["vel"], ctx), ctx)

    def same(a, b) -> bool:
        return (all(np.float64(getattr(a, k)).tobytes() == np.float64(getattr(b, k)).tobytes()
                    for k in FORCE_SUMS16)
                and a.pressure_map.tobytes() == b.pressure_map.tobytes()
                and a.shear_map.tobytes() == b.shear_map.tobytes())

    def timed(fn, n=50):
        """n evaluations, the card drained before each: (results, counters
        added, median host ms)."""
        before, out, ms = spans.snapshot(), [], []
        for _ in range(n):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out.append(fn())
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, spans.since(before)["counts"], statistics.median(ms)

    ref, eager_counts, eager_ms = timed(lambda: eager(fine))
    got, counts, graph_ms = timed(lambda: forces.compute_aerodynamics(fine, ctx))
    equal = all(same(r, ref[0]) for r in ref + got)
    # a call later the replay reads the new state where it lies
    states = prog.run(states, t, prog.n_call)
    later = spans.snapshot()
    after = forces.compute_aerodynamics(states[-1], ctx)
    later = spans.since(later)["counts"]
    moved = not same(after, ref[0])
    equal_later = same(after, eager(states[-1]))
    # two copies of the state: a second graph, then an eager evaluation past the cap
    caps = []
    for _ in range(2):
        copy = {k: states[-1][k].clone() for k in ("rho", "vel")}
        before = spans.snapshot()
        r = forces.compute_aerodynamics(copy, ctx)
        caps.append((spans.since(before)["counts"], same(r, after)))
    want = {"sync.forces": 50, "forces.capture": 1, "forces.graph": 49}
    want_caps = [{"sync.forces": 1, "forces.capture": 1}, {"sync.forces": 1, "forces.eager": 1}]
    out = {"bit_equal": equal and equal_later and all(e for _, e in caps),
           "forces.capture": counts.get("forces.capture", 0),
           "forces.graph": counts.get("forces.graph", 0),
           "syncs_per_sample": counts.get("sync.forces", 0) / 50,
           "eager_syncs_per_sample": eager_counts.get("sync.forces", 0) / 50,
           "host_ms_graph": round(graph_ms, 4), "host_ms_eager": round(eager_ms, 4),
           "pool_bytes": ctx.graphs.pool_bytes, "n_tri": ctx.n_tri}
    print(f"[16 forces] Re10M finest level {tuple(fine['rho'].shape)}, {ctx.n_tri} "
          f"triangles: 50 graph evaluations against 50 eager ones bit-equal {equal} "
          f"(Cd {ref[0].Cd:.6f}, Cl {ref[0].Cl:.6f}) | counters graph path {counts}, "
          f"eager {eager_counts} | host ms a sample (median of 50, drained): graph "
          f"{graph_ms:.4f}, eager {eager_ms:.4f} | force graphs' pool "
          f"{ctx.graphs.pool_bytes / 1e6:.3f} MB | a call later: the forces moved {moved}, "
          f"bit-equal {equal_later}, counters {later} | copies of the state: "
          f"{caps} | phase {time.time() - t_phase:.1f} s | card: {smi}", flush=True)
    require(out["bit_equal"] and moved and counts == want
            and eager_counts == {"sync.forces": 250}
            and later == {"sync.forces": 1, "forces.graph": 1}
            and [c for c, _ in caps] == want_caps and ctx.graphs.pool_bytes > 0,
            ("force graphs", out, counts, eager_counts, later, caps))
    return out


def phase_3e(dev, smi, kw, ref=None, print_ref=None) -> dict:
    """K1 at the level shapes of the benchmark's cells (`checks.K1_SHAPES`,
    each in its cell's storage type; children with six interface faces,
    the row a wind tunnel): against its plain version (not on the row,
    whose plain step would take tens of GB), and replayed from a CUDA
    graph into preallocated outputs beside `checks.step_work`'s bound; with
    `ref` (the --reference build) bit for bit against it and timed against
    it in turns, eagerly and from a graph.  Returns {label: the times}."""
    import torch

    from open_ludwig_torch import checks
    from open_ludwig_torch.ops import cuda_step

    out = {}
    for label, shape, bf16 in checks.K1_SHAPES:
        row = label == "64m_row"
        patch, static = checks.k1_level(shape, "tunnel" if row else "iface", dev)
        b = checks.bound(*checks.step_work(patch, bf16, kw["wall_model"]), dev)
        inp = checks.random_level_inputs(patch, bf16, 25, dev)
        bufs = (torch.empty_like(inp["f"]), torch.empty(shape, device=dev),
                torch.empty_like(inp["vel"]))
        iface = checks.sub_step_planes(inp["iface"], 0)
        ms = checks.graph_ms(lambda: cuda_step.stream_collide(
            inp["f"], inp["vel"], 0.04, 9, static, patch, iface=iface, out=bufs, **kw),
            3 if row else 20)
        del inp, bufs
        err = ""
        if not row:
            r = checks.check_stream_collide(patch, static, bf16, 25, kw, dev, reps=1,
                                            plain_reps=1)
            require(r["finite"] and r["max_abs_err"] < r["tol"],
                    ("K1 at the cells' shapes", label, bf16, r["err"]))
            err = (f" | vs plain: err f/rho/vel {r['err']['f']:.2e}/{r['err']['rho']:.2e}/"
                   f"{r['err']['vel']:.2e} (tol {r['tol']:.0e})")
        out[label] = {"graph_ms": ms, "bound_ms": b["bound_ms"]}
        print(f"[3e K1] {label} {shape} {'bf16' if bf16 else 'f32 '}: from a CUDA graph "
              f"{ms:.5f} ms, {100 * b['bound_ms'] / ms:.1f}% of its bound "
              f"{b['bound_ms']:.5f} ms ({b['bytes'] / 1e6:.1f} MB){err} | card: {smi}",
              flush=True)
        if ref is not None:
            r = checks.check_step_against(ref, "stream_collide", patch, static, bf16, 25,
                                          kw, dev, reps=3 if row else 20)
            out[label]["ref"] = r
            print_ref("3e K1", "K1", label, bf16, r)
        del patch, static
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", "--k1-reference", default=None, metavar="DIR",
                    help="an earlier csrc/ directory: K1, K2, K4 and K6 are "
                    "compared with its kernels")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run", file=sys.stderr)
        return 2

    import numpy as np

    from open_ludwig_torch import bench
    from open_ludwig_torch import checkpoint as ckpt
    from open_ludwig_torch import checks
    from open_ludwig_torch import lattice as lat
    from open_ludwig_torch.io import vtk
    from open_ludwig_torch.ops import build, cuda_step, forces, ghost_planes, storage
    from open_ludwig_torch.runner import plan_case, solve_case
    from open_ludwig_torch.solver_dense import (
        build_patch_statics,
        hbm_total_patches,
        init_patch_state,
        make_batch_runner_dense,
    )
    from open_ludwig_torch.tools import probe_bz_encoding, profile_slice

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
        """Level states perturbed around rest, drawn on the card from a seed."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        w = torch.as_tensor(lat.W, dtype=torch.float32, device=dev).view(27, 1, 1, 1)
        states = []
        for p in levels:
            sh = tuple(p.interior)

            def randn(shape):
                return torch.randn(shape, generator=gen, device=dev)

            states.append({
                "f": storage.encode_f(w * (1 + 0.03 * randn((27,) + sh)), precision),
                "rho": 1 + 0.01 * randn(sh),
                "vel": 0.02 * randn((3,) + sh),
            })
        return states

    def k5_detail(r):
        """K5's two launches timed apart, its turns against K1, its layout
        and its occupancy, from a checks.check_inplace result."""
        lay, a = r["layout"], r["attrs"]
        return (f"edge copy {r['edge_copy_ms']:.4f} ms + step {r['step_ms']:.4f} ms"
                f" | in turns K5, K1, K1, K5: "
                + ", ".join(f"{t:.4f}" for t in r["turns_ms"])
                + f" ms | tiles of {lay['ty']} rows x chunks of {lay['chunk']}, "
                f"runs of {lay['xr']}, edge buffer {lay['edge_elems'] / 1e6:.2f}M "
                f"elements | {a['registers']} registers, {a['local_bytes']} B "
                f"local, {a['smem_bytes']} B shared, {a['blocks_per_sm']} "
                "block(s) per SM")

    def print_ref(tag, kname, label, bf16, r):
        """A kernel against its --reference build on the same input."""
        graph = ("" if "graph_turns_ms" not in r else " | from a CUDA graph: "
                 + ", ".join(f"{t:.5f}" for t in r["graph_turns_ms"]) + " ms")
        print(f"[{tag}] {label} {'bf16' if bf16 else 'f32 '} vs the reference "
              f"{kname}: {100 * r['diff_frac']:.5f}% stored f differ (max "
              f"{r['max_abs_err']:.2e}, every output equal: {r['equal']}) | in turns "
              f"{kname}, reference, reference, {kname}: "
              + ", ".join(f"{t:.5f}" for t in r["turns_ms"]) + f" ms{graph} | card: {smi}",
              flush=True)

    def print_k2(tag, plan, bf16, r):
        print(f"[{tag}] box {tuple(plan['dim'])} {'bf16' if bf16 else 'f32 '}, "
              f"{r['links']} links: err {r['max_abs_err']:.2e} (tol {r['tol']:.0e}, "
              f"{r['changed']} slots changed) | kernel {r['ms']:.5f} ms (from a CUDA "
              f"graph {r['graph_ms']:.5f} ms), bound "
              f"{r['bound_ms']:.6f} ms ({r['bytes'] / 1e3:.1f} kB of links; the box "
              f"sweep's {r['box_bound_ms']:.6f}) | allocated per call "
              f"{r['peak_bytes']} B | plain {r['plain_ms']:.3f} ms | card: {smi}",
              flush=True)
        require(r["changed"] > 0 and r["max_abs_err"] < r["tol"]
                and r["peak_bytes"] == 0, (tag, bf16, r))

    def states_equal(a, b) -> bool:
        """Level states equal bit for bit (bf16 compared as its bits)."""
        def bits(t):
            return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return len(a) == len(b) and all(
            torch.equal(bits(x[k]), bits(y[k]))
            for x, y in zip(a, b) for k in ("f", "rho", "vel"))

    def cloned(states):
        """A copy of level states that an in-place (K5) run may overwrite."""
        return [{**st, "f": st["f"].clone()} for st in states]

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    dev = torch.device("cuda", 0)
    none = {k: 0 for k in cuda_step.LAUNCHES}  # every launch counter at zero
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = checks.nvidia_smi()
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
    knames = build.KERNELS
    t0 = time.time()
    for kname, b in zip(knames, build.load_all(knames)):
        res = [ln.strip() for ln in b.ptxas_log.splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"[2 build] {kname}: {b.seconds:.1f} s -> {b.path}", flush=True)
        for ln in res:
            print(f"[2 build]   {ln}")
    print(f"[2 build] all kernels in {time.time() - t0:.1f} s (parallel nvcc)")
    for fn in checks.ptxas_summary(build.load("stream_collide_flat").ptxas_log):
        shape = "<" + ", ".join(re.findall(r"Li(\d+)E", fn["function"])) + ">"
        print(f"[2 build] K4 {'bf16' if 'bfloat16' in fn['function'] else 'f32 '} "
              f"{shape} (threads, min blocks a SM): {fn['registers']} registers, "
              f"spill stores {fn['spill_stores']} B, spill loads "
              f"{fn['spill_loads']} B", flush=True)
    refs = {}  # kernel name -> its build from --reference DIR
    if opts.reference:
        for kname in knames:
            if os.path.isfile(os.path.join(opts.reference, kname + ".cu")):
                refs[kname] = build.load(kname, opts.reference)
                print(f"[2 build] {kname} reference from {opts.reference}: "
                      f"{refs[kname].seconds:.1f} s -> {refs[kname].path}", flush=True)
    for bf16 in (False, True):
        a = cuda_step.fused_pair_attrs(bf16)
        print(f"[2 build] fused_pair {'bf16' if bf16 else 'f32 '}: "
              f"{a['registers']} registers, {a['local_bytes']} B local, "
              f"{a['smem_bytes']} B shared per block, {a['blocks_per_sm']} "
              "block(s) per SM", flush=True)
        require(a["blocks_per_sm"] >= 1, ("fused_pair occupancy", bf16, a))
        lay = cuda_step.inplace_layout(432, 384, 384, dev, 2 if bf16 else 4)
        a = cuda_step.inplace_attrs(bf16, lay)
        print(f"[2 build] stream_collide_inplace {'bf16' if bf16 else 'f32 '} at "
              f"432x384x384 (tiles of {lay['ty']} rows, chunks of {lay['chunk']} "
              f"cells, runs of {lay['xr']} planes, {lay['nty'] * lay['nr']} blocks, "
              f"edge buffer {lay['edge_elems'] / 1e6:.1f}M elements): "
              f"{a['registers']} registers, {a['local_bytes']} B local, "
              f"{a['smem_bytes']} B shared per block, {a['blocks_per_sm']} "
              "block(s) per SM", flush=True)
        require(a["blocks_per_sm"] >= 1, ("stream_collide_inplace occupancy", bf16, a))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        cfg, mesh, params, levels = checks.bench_case(os.path.join(tmp, "bench"))
        statics = build_patch_statics(cfg, levels, dev)
        print(f"[3 K1] bench case built in {time.time() - t0:.1f} s: "
              + ", ".join(f"L{p.level_id} {p.interior}" for p in levels), flush=True)
        kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                  inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
        # the card's rule on the bench case: K4, K1, K1; the launches a
        # coarse step executes at the runner's defaults, unfused (phases 5,
        # 9 and 14 count them), and with fuse2=True, the JAX package's K3
        # pairs (phase 4c)
        print("[3 K1] the card's rule on the bench case: " + "; ".join(
            f"L{p.level_id} {st['engine']} ({st['engine_why']})"
            for p, st in zip(levels, statics)), flush=True)
        require([st["engine"] for st in statics] == ["flat", "k1", "k1"],
                ("bench engines", [st["engine"] for st in statics]))
        bench_step = bench.batch_launches(statics, 1, False)
        require(bench_step == {"stream_collide_flat": 1, "stream_collide": 6,
                               "bouzidi": 4},
                ("bench launches a coarse step", bench_step))
        bench_fused = bench.batch_launches(statics, 1, True)
        require(bench_fused == {"stream_collide_flat": 1, "stream_collide": 2,
                                "fused_pair": 2, "bouzidi": 2},
                ("bench launches a fused coarse step", bench_fused))
        mem_rows = []  # (run, `bench.memory_fields`), checked at the end

        def estimated(m, est):
            """`bench.memory_fields` `m` with the estimate `est` (bytes)."""
            return {**m, "estimate_gb": est / 1e9,
                    "estimate_over_peak": est / 1e9 / m["peak_gb"]}

        def mem_row(tag, m):
            """Print a run's memory (`bench.memory_fields`: its allocated and
            reserved peaks, the CUDA context) beside the device-memory
            estimate the card's rule reads and the card's reserve, and keep
            them for the checks at the end."""
            mem_rows.append((tag, m))
            print(f"[memory] {tag}: peak {m['peak_gb']:.3f} GB allocated, "
                  f"{m['reserved_gb']:.3f} GB reserved (above the allocated "
                  f"{m['reserved_gb'] - m['peak_gb']:.3f} GB), context "
                  f"{m['context_gb']:.3f} GB | estimate {m['estimate_gb']:.3f} GB, "
                  f"estimate / peak {m['estimate_over_peak']:.3f}; estimate + the "
                  f"card's reserve {m['estimate_gb'] + m['reserve_gb']:.3f} GB "
                  f"against reserved + context "
                  f"{m['reserved_gb'] + m['context_gb']:.3f} GB | card: {smi}",
                  flush=True)

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
                      f"{r['ms']:.4f} ms ({n / r['ms'] / 1e3:.0f} MLUPS), bound "
                      f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB) | plain "
                      f"{r['plain_ms']:.3f} ms", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"],
                        ("K1", label, bf16, r["err"], r["finite"]))
                if "stream_collide" in refs:
                    print_ref("3 K1", "K1", label, bf16, checks.check_step_against(
                        refs["stream_collide"], "stream_collide", patch, static, bf16,
                        17, kw, dev))

        # ---- 3b. the ghost planes of the bench's children ----
        for li in (1, 2):
            child, parent = levels[li], levels[li - 1]
            for bf16 in (False, True):
                r = checks.check_iface_planes(child, parent, statics[li]["iface_mm"],
                                              bf16, seed=53 + li, device=dev)
                print(f"[3b planes] L{child.level_id} {child.interior} from L"
                      f"{parent.level_id} {'bf16' if bf16 else 'f32 '}: {r['faces']}"
                      f" faces in {r['groups']} groups | vs endpoint path + "
                      f"shift_planes: f32 planes {r['max_abs_err']:.2e} (tol "
                      f"{r['tol']:.0e}), {'bf16 g' if bf16 else 'f32 f'}-space "
                      f"planes {r['store_err']:.2e} | one child build "
                      f"{r['ms']:.4f} ms eager, {r['device_ops']:.0f} device ops, "
                      f"{r['device_ms']:.4f} ms device | endpoint path "
                      f"{r['endpoint_ms']:.4f} ms | card: {smi}", flush=True)
                require(r["max_abs_err"] < r["tol"] and r["store_err"] < r["store_tol"],
                        ("ghost planes", li, bf16, r))

        # ---- 3 (continued). K1 on the 10.8M-cell single-level sweep shape ----
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
                  f" MLUPS), bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB)"
                  f" | plain {r['plain_ms']:.3f} ms", flush=True)
            require(r["finite"] and r["max_abs_err"] < r["tol"],
                    ("K1 sweep", bf16, r["err"], r["finite"]))
            if "stream_collide" in refs:
                print_ref("3 K1", "K1", "sweep", bf16, checks.check_step_against(
                    refs["stream_collide"], "stream_collide", sweep[0], sweep_static,
                    bf16, 18, kw, dev, reps=5))
        torch.cuda.empty_cache()

        # ---- 3e. K1 at the benchmark cells' level shapes ----
        phase_3e(dev, smi, kw, refs.get("stream_collide"), print_ref)
        torch.cuda.empty_cache()

        # ---- 3c/3d. K4 and K5 against plain and against K1 ----
        # level 1 cut to 61 x planes: an interface-free, non-finest level
        # the TPU's flat gate sent to K1 (no PX divides 61) and the card's
        # rule runs on K4
        x61 = dataclasses.replace(levels[0], interior=(61,) + levels[0].interior[1:],
                                  **{k: getattr(levels[0], k)[:61]
                                     for k in ("obstacle", "sponge", "wall_dist")})
        st61 = {**statics[0], **{k: statics[0][k][:61].contiguous()
                                 for k in ("obstacle", "sponge", "wall_dist")}}
        k45_cases = (
            ("L1", levels[0], checks.with_sponge_ramp(statics[0]), 20, 3),
            ("L1 x 61", x61, checks.with_sponge_ramp(st61), 20, 3),
            ("sweep", sweep[0], checks.with_sponge_ramp(sweep_static), 5, 1),
        )
        k4, k5 = {}, {}
        for tag, check, out, kname in (
                ("3c K4", checks.check_flat, k4, "stream_collide_flat"),
                ("3d K5", checks.check_inplace, k5, "stream_collide_inplace")):
            for label, patch, static, reps, plain_reps in k45_cases:
                for bf16 in (False, True):
                    r = check(patch, static, bf16, seed=21, kw=kw, device=dev,
                              reps=reps, plain_reps=plain_reps)
                    out[(label, bf16)] = r
                    n = patch.n_cells
                    print(f"[{tag}] {label} {patch.interior} "
                          f"{'bf16' if bf16 else 'f32 '} | vs plain: err f/rho/vel "
                          f"{r['err']['f']:.2e}/{r['err']['rho']:.2e}/"
                          f"{r['err']['vel']:.2e} (tol {r['tol']:.0e}) | vs K1: "
                          f"{100 * r['k1']['diff_frac']:.4f}% stored f differ, max "
                          f"{r['k1']['max_abs_err']:.2e} | kernel {r['ms']:.4f} ms "
                          f"({n / r['ms'] / 1e3:.0f} MLUPS), bound {r['bound_ms']:.4f}"
                          f" ms, K1 {r['k1_ms']:.4f} ms, plain {r['plain_ms']:.3f} "
                          f"ms | card: {smi}", flush=True)
                    require(r["finite"] and r["max_abs_err"] < r["tol"],
                            (tag, label, bf16, r["err"], r["finite"]))
                    if "same_ptr" in r:
                        require(r["same_ptr"] and r["vel_kept"]
                                and r["k1"]["diff_frac"] == 0.0,
                                (tag, label, bf16, "in-place contract", r["k1"]))
                        print(f"[{tag}]   {k5_detail(r)}", flush=True)
                    else:
                        require(r["k1"]["diff_frac"] == 0.0, (tag, label, bf16, r["k1"]))
                        c = cuda_step.flat_choice(patch, bf16)
                        want = cuda_step.flat_instantiation(n, bf16, c["resident"])
                        require(want == {k: c[k] for k in want}, (tag, label, c, want))
                        print(f"[{tag}]   {c['threads']} threads a block, launch "
                              f"bounds for {c['min_blocks']} a SM ({-(-n // c['threads'])}"
                              f" blocks; the card holds {c['resident']} of the 64-register bf16 one)",
                              flush=True)
                        print(f"[{tag}]   in turns K4, K1, K1, K4: "
                              + ", ".join(f"{t:.5f}" for t in r["turns_ms"])
                              + " ms | from a CUDA graph (K4 into preallocated "
                              "outputs): " + ", ".join(
                                  f"{t:.5f}" for t in r["graph_turns_ms"])
                              + f" ms -> K4 {r['graph_ms']:.5f} ms ("
                              f"{100 * r['bound_ms'] / r['graph_ms']:.0f}% of its "
                              f"bound), K1 {r['k1_graph_ms']:.5f} ms", flush=True)
                    if kname in refs:
                        print_ref(tag, tag[-2:], label, bf16, checks.check_step_against(
                            refs[kname], kname, patch, static, bf16, 21, kw, dev,
                            reps=reps))
        torch.cuda.empty_cache()
        # ---- 4. K2 against plain on the bench Bouzidi box ----
        plan = statics[2]["bouzidi"]
        k2 = {}
        for bf16 in (False, True):
            r = checks.check_bouzidi(levels[2], plan, bf16, seed=19, device=dev)
            k2[("bench box", bf16)] = r
            print_k2("4 K2", plan, bf16, r)
            if "bouzidi" in refs:
                print_ref("4 K2", "K2", "bench box", bf16, checks.check_bouzidi_against(
                    refs["bouzidi"], "bouzidi", levels[2], plan, bf16, 19, dev))

        # ---- 4b. K3 (+ K2) against the plain pair and the unfused kernels ----
        # also on the levels of the bench's sweep rows at res 12 (phase 14's
        # row) and res 25 (z snapped to 256), each with its own Bouzidi box,
        # where K2 is held against its plain version too
        rows4 = {}
        for res in (12, 25):
            t0 = time.time()
            b = bench.build_row(res, dev)
            rows4[f"row {b.total_cells / 1e6:.1f}M"] = (b.levels[0], b.statics[0])
            print(f"[4b K3] sweep row res {res}: {b.levels[0].interior} "
                  f"({b.total_cells / 1e6:.1f}M cells) built in {time.time() - t0:.1f}"
                  " s", flush=True)
            del b
        for label, (patch, static) in rows4.items():
            for bf16 in (False, True):
                r = checks.check_bouzidi(patch, static["bouzidi"], bf16, seed=19,
                                         device=dev)
                k2[(label, bf16)] = r
                print_k2(f"4b K2 {label}", static["bouzidi"], bf16, r)
        k3 = {}
        k3_cases = (
            ("L3", levels[2], checks.with_sponge_ramp(statics[2]), 20, 3),
            ("sweep", sweep[0], checks.with_sponge_ramp(sweep_static), 5, 1),
        ) + tuple((label, patch, checks.with_sponge_ramp(static), 5, 1)
                  for label, (patch, static) in rows4.items())
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
                      f"{100 * u['diff_frac']:.3f}% differ | K3 {r['ms']:.4f} ms "
                      f"(bound {r['bound_ms']:.4f} ms), "
                      f"K1->K2->K1 {r['unfused_ms']:.4f} ms (in turns K3, "
                      "unfused, unfused, K3: "
                      + ", ".join(f"{t:.4f}" for t in r["turns_ms"])
                      + f" ms), plain {r['plain_ms']:.3f} ms | "
                      f"{r['attrs']['registers']} registers, "
                      f"{r['attrs']['local_bytes']} B local, "
                      f"{r['attrs']['blocks_per_sm']} block(s) per SM | card: "
                      f"{smi}", flush=True)
                require(r["finite"] and r["max_abs_err"] < r["tol"],
                        ("K3 vs plain", label, bf16, r["err"]))
                require(checks.within_k3_tol(u, bf16),
                        ("K3 vs unfused kernels", label, bf16, u))
                if "fused_pair" in refs:
                    print_ref("4b K3", "K3", label, bf16, checks.check_step_against(
                        refs["fused_pair"], "fused_pair", patch, static, bf16, 23, kw,
                        dev, reps=reps))
        del rows4, k3_cases
        torch.cuda.empty_cache()

        # ---- 4c. the card's default against the JAX package's schedule ----
        # 20 coarse steps of the bench case from one random state: the
        # runner's default (unfused, level 3 on K1 + K2) and fuse2=True (level
        # 3's sub-step pairs on K3 + K2, the former default), bit-equal; the
        # fused bf16 run's K3 launches are the kernels line's
        steps4c = 20
        for precision in ("float32", "bfloat16"):
            cfg_p = dataclasses.replace(cfg, precision=precision)
            out = []
            for fuse2 in (False, True):
                run = make_batch_runner_dense(cfg_p, params, levels, statics,
                                              fuse2=fuse2)
                cuda_step.reset_launches()
                out.append(run(random_states(levels, precision, 29), 1, steps4c))
                torch.cuda.synchronize()
                got = cuda_step.executed_launches()
                want = {**none, **{k: v * steps4c for k, v in
                                   (bench_fused if fuse2 else bench_step).items()}}
                require(got == want, ("4c launches", fuse2, got, want))
                if fuse2 and precision == "bfloat16":
                    launches_k3 = got["fused_pair"]
            for li, (a, b) in enumerate(zip(*out)):
                d = checks.state_diff(a["f"], a["rho"], a["vel"],
                                      b["f"], b["rho"], b["vel"])
                print(f"[4c default vs fused] {precision} L{li + 1} after {steps4c} "
                      f"coarse steps: max {d['max_abs_err']:.2e} (f "
                      f"{d['err']['f']:.2e}), {100 * d['diff_frac']:.3f}% stored f "
                      "differ", flush=True)
                require(states_equal([a], [b]), ("default vs fused", precision, li, d))
            del out
        torch.cuda.empty_cache()

        # ---- 5. the slice through the runner ----
        base = bench.memory_start(dev)
        cuda_step.reset_launches()
        ghost_planes.reset_launches()
        res = solve_case(cfg, device="cuda")
        launches = cuda_step.executed_launches()
        launches_ghost = ghost_planes.executed_launches()
        mem_row("5 bench solve_case", bench.memory_fields(
            dev, base, hbm_total_patches(levels, statics, cfg.precision)))
        steps = cfg.steps
        want_ghost = ghost_launches([st["engine"] for st in statics],
                                    cfg.temporal_interpolation, steps)
        print(f"[5 slice] launches {launches} and the ghost planes' {launches_ghost} "
              f"(want {want_ghost}) over {steps} coarse steps", flush=True)
        require(launches == {**none, **{k: v * steps for k, v in bench_step.items()}},
                ("slice launches", launches))
        require(launches_ghost == want_ghost, ("slice ghost launches", launches_ghost,
                                               want_ghost))
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
        # every CUDA launch of a coarse step, after warm-up
        run5 = make_batch_runner_dense(cfg, params, levels, statics)
        states5 = run5([init_patch_state(p, cfg.precision, dev) for p in levels], 1, 20)
        p5, states5 = profile_slice.profile_steps(run5, states5, 21, 10,
                                                  res.updates_per_coarse)
        print(f"[5 slice] 10 coarse steps after 20 of warm-up, one call each: "
              f"{p5['ms']:.3f} ms/coarse step ({p5['mlups_su']:.1f} MLUPS-su; CUDA "
              f"events) | under torch.profiler: {measured(p5['device_ops'])} CUDA "
              f"device operations per coarse step, the port's launches "
              f"{p5['port_launches']} ({measured(p5['port_kernels'])} of its kernels "
              f"seen), device time {measured(p5['port_device_ms'], '.3f')} ms in the "
              f"port's kernels + {measured(p5['other_device_ms'], '.3f')} ms in the "
              f"rest, device busy {measured(p5['busy_share'], '.1%')} of "
              f"{p5['window_ms'] / 10:.3f} ms per profiled step | card: {smi}",
              flush=True)
        print("[5 slice] most launched: " + "; ".join(
            f"{t['per_call']:.0f} x {t['name']}" for t in p5["top"]), flush=True)
        require(all(bool(torch.isfinite(s["rho"]).all()) for s in states5),
                "profiled slice states")
        del run5, states5

        # ---- 6. the single-level path: pairs of coarse steps ----
        t0 = time.time()
        cfg1, _, params1, levels1 = checks.bench_case(
            os.path.join(tmp, "single"), surface_resolution=25, num_levels=1,
            steps=75, diag_freq=25)
        print(f"[6 single] case written in {time.time() - t0:.1f} s", flush=True)
        base = bench.memory_start(dev)
        cuda_step.reset_launches()
        res1 = solve_case(cfg1, device="cuda")
        got = cuda_step.executed_launches()
        mem6 = bench.memory_fields(dev, base, 0)  # estimate: with the statics below
        sizes = [b - a + 1 for a, b, _ in res1.windows]
        want = {**none, "stream_collide": sum(sizes), "bouzidi": sum(sizes)}
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
        mem_row("6 10.8M solve_case", estimated(
            mem6, hbm_total_patches(levels1, statics1, cfg1.precision)))
        state1 = random_states(levels1, cfg1.precision, 31)
        # one checkpoint of the level: host fetch, zip write, load back
        t0 = time.time()
        members = ckpt.fetch_members(75, state1)
        t_fetch = time.time() - t0
        path6 = os.path.join(tmp, "ckpt_single.npz")
        t0 = time.time()
        ckpt.write_members(path6, members)
        t_write = time.time() - t0
        del members
        t0 = time.time()
        _, loaded = ckpt.load_checkpoint(path6, device=dev)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        require(states_equal(state1, loaded), "10.8M checkpoint round trip")
        print(f"[6 single] checkpoint of the {res1.total_cells / 1e6:.3f}M-cell "
              f"{cfg1.precision} state: {os.path.getsize(path6) / 1e9:.3f} GB | host "
              f"fetch {t_fetch:.3f} s, zip write {t_write:.3f} s, load to the card "
              f"{t_load:.3f} s (bit-equal) | card: {smi}", flush=True)
        os.remove(path6)
        del loaded
        per_step = {True: [], False: []}
        for fuse2 in (True, False, False, True):
            run = make_batch_runner_dense(cfg1, params1, levels1, statics1,
                                          fuse2=fuse2)
            state = cloned(state1)
            per_step[fuse2].append(
                checks.time_cuda(lambda: run(list(state), 1, 50), reps=1) / 50)
            del state
        print("[6 single] 50-step batch, per coarse step (fused, unfused, "
              "unfused, fused): " + ", ".join(
                  f"{ms:.4f} ms" for ms in (per_step[True][0], *per_step[False],
                                            per_step[True][1]))
              + f" -> fused {res1.total_cells / min(per_step[True]) / 1e3:.0f}, "
              f"unfused {res1.total_cells / min(per_step[False]) / 1e3:.0f} "
              f"MLUPS | card: {smi}", flush=True)
        del state1, statics1
        torch.cuda.empty_cache()

        # ---- 7. the 63.7M-cell single-level row: the card's rule, and K5 ----
        t0 = time.time()
        cfg7 = checks.bench_config(
            os.path.join(tmp, "row64"), surface_resolution=45, num_levels=1,
            domain_tile_snap=True, steps=20, diag_freq=10)
        base = bench.memory_start(dev)
        cuda_step.reset_launches()
        res7 = solve_case(cfg7, device="cuda")
        got7 = cuda_step.executed_launches()
        mem7 = bench.memory_fields(dev, base, 0)  # estimate: with the statics below
        steps7 = cfg7.steps
        print(f"[7 in place] solve_case at the card's capacity: launches {got7} over "
              f"{steps7} coarse steps", flush=True)
        require(got7 == {**none, "stream_collide": steps7, "bouzidi": steps7},
                ("63.7M launches", got7))
        check_run_outputs(res7, cfg7)
        win = res7.windows[1:]
        n_steps = sum(b - a + 1 for a, b, _ in win)
        sec = sum(ms for _, _, ms in win) / 1e3
        mlups7 = res7.total_cells * n_steps / sec / 1e6
        print(f"[7 in place] {res7.total_cells / 1e6:.3f}M cells | {n_steps} steps "
              f"after the first batch in {sec:.3f} s (CUDA events) -> {mlups7:.1f} "
              f"MLUPS | {sec / n_steps * 1e3:.3f} ms/coarse step | rho_min "
              f"{res7.final_stats.rho_min:.4f} | Cd {res7.final_forces.Cd:.4f} | "
              f"phase {time.time() - t0:.1f} s (host set-up included) | card: "
              f"{smi}", flush=True)
        require(abs(res7.total_cells - 63.70e6) < 0.01e6, ("63.7M row", res7.total_cells))

        # the row's own level (sphere, wall model, Bouzidi box): K5 against
        # its plain version and K1, K2 against its plain version
        t0 = time.time()
        _, params7, levels7 = checks.case_levels(cfg7)
        statics7 = build_patch_statics(cfg7, levels7, dev)
        row, st7 = levels7[0], statics7[0]
        print(f"[7 in place] row level {row.interior} rebuilt in "
              f"{time.time() - t0:.1f} s, engine {st7['engine']}: "
              f"{st7['engine_why']}", flush=True)
        require(st7["engine"] == "k1" and "fits" in st7["engine_why"]
                and st7["bouzidi"] is not None, ("63.7M engine", st7["engine"],
                                                 st7["engine_why"]))
        mem_row("7 63.7M solve_case (K1)", estimated(
            mem7, hbm_total_patches(levels7, statics7, cfg7.precision)))
        r = checks.check_inplace(row, checks.with_sponge_ramp(st7), True, seed=37,
                                 kw=kw, device=dev, reps=5, plain_reps=1)
        k5[("row", True)] = r
        print(f"[7 in place] K5 on the row {row.interior} bf16 | vs plain: err "
              f"f/rho/vel {r['err']['f']:.2e}/{r['err']['rho']:.2e}/"
              f"{r['err']['vel']:.2e} (tol {r['tol']:.0e}) | vs K1: "
              f"{100 * r['k1']['diff_frac']:.4f}% stored f differ | K5 "
              f"{r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms, "
              f"{r['bytes'] / 1e9:.2f} GB), K1 {r['k1_ms']:.3f} ms, plain {r['plain_ms']:.1f}"
              f" ms | peak allocated during the plain step "
              f"{r['plain_peak_bytes'] / 1e9:.2f} GB | card: {smi}", flush=True)
        print(f"[7 in place]   {k5_detail(r)}", flush=True)
        require(r["finite"] and r["max_abs_err"] < r["tol"] and r["same_ptr"]
                and r["vel_kept"] and r["k1"]["diff_frac"] == 0.0,
                ("K5 on the 63.7M row", r["err"], r["k1"]))
        plan7 = st7["bouzidi"]
        r = checks.check_bouzidi(row, plan7, True, seed=39, device=dev)
        k2[(f"row {row.n_cells / 1e6:.1f}M", True)] = r
        print_k2("7 in place: K2 on the row", plan7, True, r)
        torch.cuda.empty_cache()

        # peak allocation above the live state of one K5 and one K1 step
        state7 = random_states(levels7, cfg7.precision, 41)
        f7, args = state7[0]["f"], (state7[0]["vel"], 0.04, 3, st7, row)
        f_k5 = f7.clone()
        peak5 = checks.step_peak_bytes(
            lambda: cuda_step.stream_collide_inplace(f_k5, *args, **kw), dev)
        peak1 = checks.step_peak_bytes(
            lambda: cuda_step.stream_collide(f7, *args, **kw), dev)
        del f_k5, args
        f_bytes = f7.numel() * f7.element_size()
        out_bytes = row.n_cells * 16  # rho + vel outputs
        print(f"[7 in place] one step on the row, peak above live state: K5 "
              f"{peak5 / 1e9:.3f} GB (rho + vel {out_bytes / 1e9:.3f} GB, edge "
              f"buffer {(peak5 - out_bytes) / 1e9:.3f} GB = "
              f"{100 * (peak5 - out_bytes) / f_bytes:.1f}% of f), K1 "
              f"{peak1 / 1e9:.3f} GB (f copy {f_bytes / 1e9:.3f} GB)", flush=True)
        require(peak5 <= out_bytes + 0.25 * f_bytes and peak1 >= f_bytes,
                ("K5 / K1 peak memory at 63.7M", peak5, peak1))

        # the card's rule under a capacity cut between the row's K5 and K1
        # estimates picks K5; that path (its statics and a graphed 10-step
        # batch on a copy of the perturbed state, which K5 updates in place)
        # peaks under the capacity and the estimate, the state's own bytes
        # counted
        del f7
        est_k1 = hbm_total_patches(levels7, statics7, cfg7.precision)
        est_k5 = hbm_total_patches(levels7, [{**st7, "engine": "inplace"}],
                                   cfg7.precision)
        cut = (est_k1 + est_k5) // 2
        # a copy of every tensor, counted in the peaks: the runner lets the
        # first rho and vel go after its first step, as it does a caller's
        # states
        base = bench.memory_start(dev)
        in7 = [{k: st[k].clone() for k in ("f", "rho", "vel")} for st in state7]
        in_bytes = sum(t.numel() * t.element_size()
                       for t in (in7[0]["f"], in7[0]["rho"], in7[0]["vel"]))
        statics7c = build_patch_statics(cfg7, levels7, dev, capacity=cut)
        run7c = make_batch_runner_dense(cfg7, params7, levels7, statics7c)
        cuda_step.reset_launches()
        out7c = run7c(in7, 1, 10)[0]
        torch.cuda.synchronize()
        got7c = cuda_step.executed_launches()
        mem7c = bench.memory_fields(dev, base, est_k5)
        peak7c = mem7c["peak_gb"] * 1e9
        del in7
        launches_k5 = got7c["stream_collide_inplace"]
        print(f"[7 in place] the card's rule at a capacity of {cut / 1e9:.3f} GB "
              f"(estimates: K1 {est_k1 / 1e9:.3f} GB, K5 {est_k5 / 1e9:.3f} GB): "
              f"engine {statics7c[0]['engine']} ({statics7c[0]['engine_why']}) | 10 "
              f"steps: launches {dict((k, v) for k, v in got7c.items() if v)}, peak "
              f"allocated {peak7c / 1e9:.3f} GB (the state's "
              f"{in_bytes / 1e9:.3f} GB included) | card: "
              f"{smi}", flush=True)
        require(statics7c[0]["engine"] == "inplace" and peak7c <= cut
                and got7c == {**none, "stream_collide_inplace": 10, "bouzidi": 10},
                ("63.7M under a capacity cut", statics7c[0]["engine"], peak7c, cut,
                 got7c))
        mem_row("7 63.7M K5 batch under the cut", mem7c)
        del run7c, statics7c
        torch.cuda.empty_cache()

        # a 10-step batch of the row from one perturbed state on the card's
        # default (K1 unfused), on K5 (the row's former default) and on K3
        # pairs + K2 (the JAX package's fused schedule on its 1-D kernel): all
        # three bit-equal; then each timed, in turns
        runs7 = {
            "K1": make_batch_runner_dense(cfg7, params7, levels7, statics7),
            "K5": make_batch_runner_dense(cfg7, params7, levels7,
                                          [{**st7, "engine": "inplace"}]),
            "K3": make_batch_runner_dense(cfg7, params7, levels7, statics7,
                                          fuse2=True),
        }
        out7 = {"K5": out7c}
        for k in ("K1", "K3"):
            out7[k] = runs7[k](cloned(state7), 1, 10)[0]
        torch.cuda.synchronize()
        d1 = checks.state_diff(*(out7["K5"][k] for k in ("f", "rho", "vel")),
                               *(out7["K1"][k] for k in ("f", "rho", "vel")))
        d3 = checks.state_diff(*(out7["K1"][k] for k in ("f", "rho", "vel")),
                               *(out7["K3"][k] for k in ("f", "rho", "vel")))
        rho1 = out7["K1"]["rho"]
        print(f"[7 in place] 10 steps from a perturbed state: the default (K1) vs K5 "
              f"{100 * d1['diff_frac']:.4f}% stored f differ (max "
              f"{d1['max_abs_err']:.2e}); vs K3 pairs {100 * d3['diff_frac']:.4f}%"
              f" (max {d3['max_abs_err']:.2e}); rho {float(rho1.min()):.4f}.."
              f"{float(rho1.max()):.4f}", flush=True)
        require(d1["finite"] and states_equal([out7["K1"]], [out7["K5"]])
                and states_equal([out7["K1"]], [out7["K3"]]),
                ("63.7M batch: the default vs K5 and K3", d1, d3))
        del out7, out7c
        per7 = {k: [] for k in runs7}
        for k in ("K5", "K3", "K1", "K1", "K3", "K5"):
            state = cloned(state7)
            per7[k].append(checks.time_cuda(lambda: runs7[k](state, 1, 10), reps=1,
                                            warmup=0) / 10)
            del state
        print("[7 in place] 10-step batch of the row, per coarse step, in turns "
              "(K5, K3 pairs, K1, K1, K3 pairs, K5): " + ", ".join(
                  f"{k} {ms:.3f} ms" for k in runs7 for ms in per7[k])
              + " -> " + ", ".join(
                  f"{k} {res7.total_cells / min(per7[k]) / 1e3:.0f} MLUPS"
                  for k in runs7) + f" | card: {smi}", flush=True)
        row7 = (cfg7, params7, levels7, statics7, state7)
        del runs7, row, st7
        torch.cuda.empty_cache()

        # ---- 8. the probe's path: K6, the two-array Bouzidi ----
        k6 = {}
        for bf16 in (False, True):
            r = checks.check_bouzidi_ab(levels[2], plan, bf16, seed=43, device=dev)
            k6[bf16] = r
            print(f"[8 K6] box {tuple(plan['dim'])} {'bf16' if bf16 else 'f32 '}, "
                  f"{r['links']} links | vs plain: err {r['max_abs_err']:.2e} (tol "
                  f"{r['tol']:.0e}, {r['changed']} slots changed) | vs K2 on the same "
                  f"S: {r['k2_err']:.2e} | links {r['ms']:.5f} ms (from a CUDA graph "
                  f"{r['graph_ms']:.5f} ms), bound {r['bound_ms']:.6f} ms "
                  f"({r['bytes'] / 1e3:.1f} kB of links; the box sweep's "
                  f"{r['box_bound_ms']:.6f}), K2 {r['k2_ms']:.5f} ms (graph "
                  f"{r['k2_graph_ms']:.5f}); in turns K6, K2, K2, K6: "
                  + ", ".join(f"{t:.5f}" for t in r["turns_ms"]) + " ms, graph "
                  + ", ".join(f"{t:.5f}" for t in r["graph_turns_ms"])
                  + f" ms | allocated per call {r['peak_bytes']} B | plain "
                  f"{r['plain_ms']:.3f} ms | card: {smi}", flush=True)
            require(r["changed"] > 0 and r["max_abs_err"] < r["tol"]
                    and r["k2_err"] < r["tol"] and r["peak_bytes"] == 0, ("K6", bf16, r))
            if "bouzidi_ab" in refs:
                print_ref("8 K6", "K6", "bench box", bf16, checks.check_bouzidi_against(
                    refs["bouzidi_ab"], "bouzidi_ab", levels[2], plan, bf16, 43, dev))
        cuda_step.reset_launches()
        probe = probe_bz_encoding.main([])
        got8 = probe["launches"]  # at the end of its windows, before its graphs
        apps = 2 + probe["reps"] * probe["n"]  # check, warm-up, windows
        gr = probe["graph_ms"]
        print(f"[8 probe] launches {got8} | K2 {probe['ms_min']['S']:.5f}, K6 "
              f"{probe['ms_min']['AB']:.5f} ms per application (best of "
              f"{probe['reps']} windows of {probe['n']}) -> K6 / K2 "
              f"{probe['ms_min']['AB'] / probe['ms_min']['S']:.3f} | from a CUDA "
              f"graph K2 {gr['S']:.5f}, K6 {gr['AB']:.5f} ms -> K6 / K2 "
              f"{gr['AB'] / gr['S']:.3f} | card: {smi}", flush=True)
        require(got8 == {**{k: 0 for k in got8}, "bouzidi": apps, "bouzidi_ab": apps},
                ("probe launches", got8, apps))
        require(probe["dim"] == tuple(plan["dim"]) and probe["max_abs_err"] < 2e-3,
                ("probe box and K6 vs K2", probe["dim"], probe["max_abs_err"]))

        # ---- 9. the runner's outputs and restarts on the bench case ----
        per_step = {**none, **bench_step}
        cfg9 = checks.bench_config(
            os.path.join(tmp, "outputs"), steps=200, output_freq=100,
            diag_freq=100).with_overrides(force_method="momentum_exchange",
                                          checkpoint_freq=100)
        # 9b: a full solve with every output on
        t0 = time.time()
        cuda_step.reset_launches()
        res9 = solve_case(cfg9, device="cuda")
        got9 = cuda_step.executed_launches()
        print(f"[9b outputs] launches {got9} over {cfg9.steps} coarse steps | "
              f"solve {time.time() - t0:.1f} s (set-up and outputs included)",
              flush=True)
        require(got9 == {k: n * cfg9.steps for k, n in per_step.items()},
                ("outputs run launches", got9))
        check_run_outputs(res9, cfg9)
        require(res9.final_forces.force_map is not None, "MEM forces in the run")
        out9 = cfg9.output_path
        for kind, step, path, sec in res9.outputs:
            print(f"[9b outputs] {kind} at step {step}: {os.path.basename(path)} "
                  f"{os.path.getsize(path) / 1e6:.1f} MB in {1e3 * sec:.1f} ms"
                  + (" (host fetch; the write runs on a thread)"
                     if kind == "checkpoint" else "") + f" | card: {smi}", flush=True)
        names = sorted(f for f in os.listdir(out9) if f.endswith(".vtu"))
        require(names == ["flow_000100.vtu", "flow_000200.vtu",
                          "surface_000100.vtu", "surface_000200.vtu"], names)
        for fname in names:
            arrs = vtk.read_vtu(os.path.join(out9, fname))
            if fname.startswith("flow"):
                n = len(arrs["Level"])
                require(arrs["Velocity"].shape == (n, 3) and n > 0
                        and bool(np.isfinite(arrs["Velocity"]).all()), (fname, n))
            else:
                require(len(arrs["Pressure_Pa"]) == mesh.n_triangles
                        and bool(np.isfinite(arrs["Pressure_Pa"]).all()), fname)
        ck_dir = os.path.join(out9, "checkpoints")
        require(sorted(os.listdir(ck_dir)) == ["ckpt_00000100.npz",
                                               "ckpt_00000200.npz"], "9b checkpoints")
        path200 = os.path.join(ck_dir, "ckpt_00000200.npz")
        _, final9 = ckpt.load_checkpoint(path200, cfg9.precision, dev)
        t0 = time.time()
        members = ckpt.fetch_members(200, final9)
        t_fetch = time.time() - t0
        t0 = time.time()
        ckpt.write_members(os.path.join(tmp, "ckpt_bench.npz"), members)
        t_write = time.time() - t0
        nbytes = sum(a.nbytes for _, a in members)
        del members
        print(f"[9b outputs] one checkpoint of the {res9.total_cells / 1e6:.3f}M-cell "
              f"state: {nbytes / 1e6:.1f} MB | host fetch {1e3 * t_fetch:.1f} ms, zip "
              f"write {1e3 * t_write:.1f} ms | card: {smi}", flush=True)

        # 9a: MEM on the card from 9b's final state against float64
        ctx9 = forces.make_mem_context(levels[-1], params, mesh, g_storage=True,
                                       device=dev)
        fr9 = forces.compute_aerodynamics_mem(final9[-1], ctx9)
        ref9 = checks.mem_float64(final9[-1]["f"], ctx9)
        e9 = checks.mem_errors(fr9, ref9)
        sctx9 = forces.make_force_context_dense(mesh, levels[-1], params, device=dev)
        mem_ms = checks.time_cuda(
            lambda: forces.compute_aerodynamics_mem(final9[-1], ctx9), reps=20)
        stress_ms = checks.time_cuda(
            lambda: forces.compute_aerodynamics(final9[-1], sctx9), reps=20)
        print(f"[9a MEM] {ctx9.n_links} fluid/solid links on L{levels[-1].level_id} "
              f"{levels[-1].interior} | vs float64 on a host copy: |error| / bound F "
              f"{e9['F']:.3f}, M {e9['M']:.3f}, force map {e9['force_map']:.3f} "
              f"(bound 1e-5 x sum |link contribution|) | Cd {fr9.Cd:.5f} (float64 "
              f"{ref9['F'][0] / (ctx9.q_inf * ctx9.area_ref):.5f}) | one MEM "
              f"evaluation {mem_ms:.4f} ms, one stress-mapping evaluation "
              f"{stress_ms:.4f} ms (eager, CUDA events, host fetch included) | "
              f"card: {smi}", flush=True)
        require(e9["ok"] and np.isfinite(fr9.Cd), ("MEM on the card", e9))

        # 9c: resume from step 100 to 200, bit-equal to 9b
        os.remove(path200)
        t0 = time.time()
        cuda_step.reset_launches()
        res9c = solve_case(cfg9.with_overrides(checkpoint_resume=True), device="cuda")
        got9c = cuda_step.executed_launches()
        require(res9c.resume_step == 100 and got9c == {
            k: n * 100 for k, n in per_step.items()}, ("resumed run", got9c))
        _, resumed = ckpt.load_checkpoint(path200, cfg9.precision, dev)
        diffs = [checks.state_diff(a["f"], a["rho"], a["vel"],
                                   b["f"], b["rho"], b["vel"])
                 for a, b in zip(final9, resumed)]
        equal = states_equal(final9, resumed)
        for fname in ("convergence.csv", "forces.csv"):
            with open(os.path.join(out9, fname)) as fh:
                steps9 = [int(r["Step"]) for r in csv.DictReader(fh)]
            require(steps9 == [100, 200], (fname, steps9))
        print(f"[9c resume] from step {res9c.resume_step} to {cfg9.steps} in "
              f"{time.time() - t0:.1f} s: final state bit-equal to the "
              f"uninterrupted run's: {equal} (per level max |diff| "
              + ", ".join(f"{d['max_abs_err']:.2e}" for d in diffs)
              + ") | CSVs hold each step once", flush=True)
        require(equal, ("resumed run against the uninterrupted one", diffs))
        del final9, resumed, ctx9, sctx9

        # 9d: the plan, with the card's capacity
        plan9 = plan_case(cfg9, device="cuda")
        cap = plan9["capacity"]
        print(f"[9d plan] {plan9['total_cells'] / 1e6:.3f}M cells | capacity of "
              f"this card: {cap['k1'] / 1e6:.0f}M cells on A->B levels, "
              f"{cap['inplace'] / 1e6:.0f}M in place | card: {smi}", flush=True)
        require(plan9["total_cells"] == res9.total_cells
                and cap["inplace"] > cap["k1"] > 100 * plan9["total_cells"], plan9)

        # ---- 10. the x-slab multi-device path ----
        k10, launches10 = phase_10(dev, smi, kw, tmp, mesh, params, levels, statics,
                                   (sweep[0], sweep_static), row7)
        # phase 7's row is done with: its state and statics would hold
        # segments whose free blocks the later runs fill
        del row7, sweep, sweep_static, cfg7, params7, levels7, statics7, state7

        # ---- 11. the blocks layout, and async_depth ----
        del statics
        phase_11(dev, smi, tmp, check_run_outputs, states_equal)

        # ---- 12. the shipped cases ----
        phase_12(dev, smi, tmp, check_run_outputs, mem_row)

        # ---- 13. the batch as one program: graphs against the eager loop ----
        out13 = phase_13(dev, smi, tmp, random_states, states_equal)

        # ---- 14. the bench entry point ----
        phase_14(smi, tmp, out13[("bench", "bfloat16")], bench_step, mem_row)

        # ---- 15. the ghost planes' kernels ----
        k15, launches15 = phase_15(dev, smi, tmp)

        # ---- 16. a force sample as one graph replay ----
        f16 = phase_16(dev, smi)

    # every run's device-memory estimate (the card's rule reads it) at or
    # above its measured peak
    low = [tag for tag, m in mem_rows if m["estimate_gb"] < m["peak_gb"]]
    # and with the card's reserve, at or above what the card held: the
    # allocator's reserved peak and the CUDA context
    short = [tag for tag, m in mem_rows
             if m["estimate_gb"] + m["reserve_gb"] < m["reserved_gb"] + m["context_gb"]]
    print(f"[memory] {len(mem_rows)} runs, estimate / peak "
          + ", ".join(f"{m['estimate_over_peak']:.3f}" for _, m in mem_rows)
          + f"; below 1: {low} | reserved above allocated (GB) "
          + ", ".join(f"{m['reserved_gb'] - m['peak_gb']:.3f}" for _, m in mem_rows)
          + f", context (GB) {max(m['context_gb'] for _, m in mem_rows):.3f} at most, "
          f"the card's reserve {mem_rows[0][1]['reserve_gb']:.3f} GB; estimate + "
          f"reserve below reserved + context: {short}", flush=True)
    require(not low, ("estimates below their peaks", low))
    require(not short, ("estimate + reserve below reserved + context", short))
    print(f"[done] {time.time() - t_run:.1f} s", flush=True)

    def kernel_line(kname, source, replaces, n, r, max_abs_err):
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": max_abs_err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    csrc = "open_ludwig_torch/csrc/"
    pallas = "open_ludwig_tpu/ops/pallas_step.py:"
    kernels = [
        kernel_line("stream_collide", csrc + "stream_collide.cu", pallas + "247",
                    launches["stream_collide"], k1[("L3", True)],
                    max(r["max_abs_err"] for (lab, bf), r in k1.items() if bf)),
        kernel_line("bouzidi", csrc + "bouzidi.cu", pallas + "62",
                    launches["bouzidi"], k2[("bench box", True)],
                    max(r["max_abs_err"] for (lab, bf), r in k2.items() if bf)),
        kernel_line("fused_pair", csrc + "fused_pair.cu", pallas + "961",
                    launches_k3, k3[("L3", True)],
                    max(r["max_abs_err"] for (lab, bf), r in k3.items() if bf)),
        kernel_line("stream_collide_flat", csrc + "stream_collide_flat.cu",
                    pallas + "2100", launches["stream_collide_flat"], k4[("L1", True)],
                    max(r["max_abs_err"] for (lab, bf), r in k4.items() if bf)),
        kernel_line("stream_collide_inplace", csrc + "stream_collide_inplace.cu",
                    pallas + "1575", launches_k5, k5[("row", True)],
                    max(r["max_abs_err"] for (lab, bf), r in k5.items() if bf)),
        kernel_line("bouzidi_ab", csrc + "bouzidi_ab.cu", "tools/probe_bz_encoding.py:117",
                    got8["bouzidi_ab"], k6[True],
                    max(r["max_abs_err"] for r in k6.values())),
        # no Pallas kernel: the XLA glue of extract_endpoint_slabs and
        # interface_planes_pair_mm; the fused build's launches from the slice
        # (phase 5), the two kernels' from phase 15's batches under a K5
        # parent; times of the Re10M finest level's build
        kernel_line("ghost_build", csrc + "ghost_planes.cu",
                    "open_ludwig_tpu/ops/dense_step.py:577 + :630 (XLA)",
                    launches_ghost["ghost_build"], k15[("Re10M", 3, True)]["fused"],
                    max(r["max_abs_err"] for r in k15.values())),  # = the two kernels'
        kernel_line("ghost_extract", csrc + "ghost_planes.cu",
                    "open_ludwig_tpu/ops/dense_step.py:577 (XLA)",
                    launches15["ghost_extract"], k15[("Re10M", 3, True)]["extract"],
                    0.0),  # the slabs bit-equal (phase 15 requires it)
        kernel_line("ghost_planes", csrc + "ghost_planes.cu",
                    "open_ludwig_tpu/ops/dense_step.py:630 (XLA)",
                    launches15["ghost_planes"], k15[("Re10M", 3, True)]["planes"],
                    max(r["max_abs_err"] for r in k15.values())),
    ]
    # the sharded forms: launches from phase 10's runs (K1, K4 and K2 on the
    # bench's 2 slabs, K5 on the row's), times from 10a's first bf16 check
    for kname, source, replaces in (
            ("stream_collide_shard", "stream_collide.cu", "769"),
            ("stream_collide_flat_shard", "stream_collide_flat.cu", "2134"),
            ("stream_collide_inplace_shard", "stream_collide_inplace.cu", "1647"),
            ("bouzidi_shard", "bouzidi.cu", "62")):
        rs = [r for bf, r in k10[kname] if bf]
        kernels.append(kernel_line(kname, csrc + source, pallas + replaces,
                                   launches10[kname], rs[0],
                                   max(r["max_abs_err"] for r in rs)))
    # every kernel launched on the run that drove its path (K3 and K5 on
    # their forced paths: 4c's fused runner, 7's capacity cut, 10c's cut)
    require(all(k["launches"] > 0 for k in kernels),
            ("kernels not launched", [k["name"] for k in kernels if not k["launches"]]))
    # the port's independence from the JAX package, where jax is installed
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "open_ludwig_tpu"))
    require(not loaded, ("jax or the JAX package was imported", loaded[:10]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
        "forces_graph": f16}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: MLUPS of the sphere at Re~1M, and the --sweep rows.

    python -m open_ludwig_torch.bench [--sweep] [--device cuda|cpu] [--out PATH]

The counterpart of the repo's root `bench.py` (which drives the JAX
package) for this package, on one card:
  - the headline (`headline`): the sphere at Re~1M, N=25, 3 levels plus a
    wake box, bf16 g-storage (`build_sphere_runner`, the case of
    `checks.bench_config`), through `make_batch_runner_dense` at its
    defaults (each level on the card's choice of kernel, unfused, each
    coarse step a CUDA graph replay); the case built
    3 times in the process, each build warmed up and timed over 6 windows
    of 400 coarse steps, since its speed is set per build;
  - `--sweep` (`sweep`): single-level rows at surface resolutions 12, 25,
    34, 45, 52 and 57 (1.6M to 134.1M cells), bf16 with
    `domain_tile_snap`, written to `--out` (default
    open_ludwig_torch/BENCH_SWEEP.json) after each row, before the headline,
    each with its peak allocation beside the device-memory estimate the
    card's rule reads (`solver_dense.hbm_total_patches`) and their ratio.
Each window is one call of the batch runner timed between CUDA events
with one `torch.cuda.synchronize` at its end (`time.perf_counter` on the
CPU); a row's result is the median over its windows with their min and
max, the headline's the median over the builds of each build's median,
with the min and max over every window.
The warm-up calls repeat until one is all graph replays, so no window
captures; the windows must launch exactly the kernels their coarse steps
need (`batch_launches`), and the states must stay finite.
Stdout gets one line, the headline's JSON, last; each row's build seconds
and MLUPS go to stderr.  Nothing is caught around the headline: a failure
raises and prints no result.  A sweep row that fails keeps the row's
schema with `mlups: null` and its `error`, the other rows run, and the
exit code is 1 after the headline's line.
MLUPS-su counts each level's cells times its 2^(l-1) sub-steps per coarse
step; MLUPS-ref (`value_ref`) counts cells times coarse steps, the Julia
reference's convention.  There is no `vs_baseline`: the root bench's 2000
MLUPS target is a TPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import statistics
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checks, memory
from .cases import make_case_sphere
from .config import CaseConfig, load_case_config
from .core.patch import PatchLevel
from .ops import cuda_step
from .runner import resolve_device
from .scaling import DomainParams
from .solver_dense import (
    build_patch_statics,
    hbm_total_patches,
    init_patch_state,
    make_batch_runner_dense,
)
from .tools.profile_slice import warm_up

SWEEP_RES = (12, 25, 34, 45, 52, 57)  # bench.py:188, 1.6M to 134.1M cells
SWEEP_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_SWEEP.json")
# a sweep row's case (bench.py:200-204): one level, bf16, tile-snapped box
ROW_CASE = dict(num_levels=1, steps=100, ramp_steps=50, output_freq=100000,
                diag_freq=100000, precision="bfloat16", domain_tile_snap=True)
HEADLINE_BATCH, HEADLINE_WINDOWS = 400, 6  # bench.py:260-261
# the headline's case is built, warmed up and timed this many times in the
# process: its time a coarse step is set per build (PERF.md section 7)
HEADLINE_BUILDS = 3
# what a sweep row's teardown may leave allocated on the card: the tables
# the port caches per card on first use (`lattice.tables`), far below the
# smallest row's state (1.6M cells, ~110 MB)
TEARDOWN_SLACK = 16 * 2**20

# the kernel each level's engine launches per sub-step (ops/engine.py)
_KERNEL = {"k1": "stream_collide", "flat": "stream_collide_flat",
           "inplace": "stream_collide_inplace"}
_LABEL = {"k1": "K1", "flat": "K4", "inplace": "K5"}


@dataclasses.dataclass
class Bench:
    """A built case: its batch runner (`make_batch_runner_dense`, unfused
    unless built with `fuse2`) and rest states on the device, with what
    timing it needs."""
    cfg: CaseConfig
    params: DomainParams
    levels: List[PatchLevel]
    statics: List[Dict]
    run: object
    states: List[Dict]
    total_cells: int
    updates_per_coarse: int  # cells x 2^(l-1), summed over the levels

    @property
    def engines(self) -> List[str]:
        """Each level's kernels as the runner runs them: K1 / K4 / K5 per
        sub-step (statics[l]["engine"], the card's rule's), "K3 pairs" on the
        finest level when the runner fuses it, "+ K2" with Bouzidi."""
        out = []
        for lvl, st in enumerate(self.statics):
            fused = lvl == len(self.statics) - 1 and self.run.fused2
            name = "K3 pairs" if fused else _LABEL[st["engine"]]
            out.append(name + (" + K2" if st["bouzidi"] is not None else ""))
        return out


@dataclasses.dataclass
class Windows:
    """What `time_runner` measured and ran."""
    ms: List[float]  # each timed window's milliseconds
    mlups: List[float]  # each window's MLUPS (updates_per_coarse x batch / ms)
    calls: List[Tuple[int, int]]  # every (t0, n) call, the warm-up's first
    warmup: int  # how many of `calls` were warm-up
    launches: Dict[str, int]  # kernel launches the windows executed (card)
    states: List[Dict]  # the states after the last window


def _build(cfg: CaseConfig, device: torch.device, fuse2: bool = False) -> Bench:
    """The case's statics by the card's rule (the card's memory less its
    reserve; no limit on the CPU), rest states, and the batch runner, fused
    with `fuse2`."""
    _, params, levels = checks.case_levels(cfg)
    statics = build_patch_statics(cfg, levels, device)
    states = [init_patch_state(p, cfg.precision, device) for p in levels]
    run = make_batch_runner_dense(cfg, params, levels, statics, fuse2=fuse2)
    return Bench(cfg, params, levels, statics, run, states,
                 sum(p.n_cells for p in levels),
                 sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels))


def build_sphere_runner(surface_resolution: int = 25, num_levels: int = 3,
                        device="cuda", fuse2: bool = False, **over) -> Bench:
    """The headline's case (bench.py:67-104): the sphere at Re~1M, 400
    steps, ramp 200, wake box, bf16, no output or diagnostics inside the
    run, as `checks.bench_config` writes it; `over` overrides case
    options (the tests' float32); `fuse2` as `_build`."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = checks.bench_config(tmp, surface_resolution=surface_resolution,
                                  num_levels=num_levels, diag_freq=100000, **over)
        return _build(cfg, dev, fuse2)


def build_row(res: int, device="cuda") -> Bench:
    """The sweep row at surface resolution `res` (`ROW_CASE`)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        make_case_sphere(tmp, "1M", surface_resolution=res, **ROW_CASE)
        return _build(load_case_config(tmp), dev)


def batch_launches(statics: List[Dict], n: int, fused2: bool) -> Dict[str, int]:
    """Kernel launches that n coarse steps of the batch runner in one call
    execute: level l runs n 2^(l-1) sub-steps on its engine's kernel, K2
    after each on a Bouzidi level; a fused finest level runs its sub-steps
    in K3 pairs with K2 after each pair, and a single level pairs the
    coarse steps of a call, an odd call's first step plain (K1)."""
    want: Dict[str, int] = {}

    def add(kernel: str, k: int) -> None:
        want[kernel] = want.get(kernel, 0) + k

    last = len(statics) - 1
    for lvl, st in enumerate(statics):
        sub = n * 2 ** lvl
        if lvl == last and fused2:
            plain, pairs = ((n % 2, n // 2) if n >= 2 else (n, 0)) if last == 0 \
                else (0, sub // 2)
            add("stream_collide", plain)
            add("fused_pair", pairs)
            units = plain + pairs
        else:
            add(_KERNEL[st["engine"]], sub)
            units = sub
        if st["bouzidi"] is not None:
            add("bouzidi", units)
    return {k: v for k, v in want.items() if v}


def time_runner(run, states: List[Dict], updates_per_coarse: int, batch: int,
                n_windows: int, device) -> Windows:
    """`warm_up` (`tools/profile_slice`: calls of `batch` coarse steps from
    t = 1, bench.py:136, until a graphed runner is all replays), then
    `n_windows` timed calls of `batch` coarse steps, t counted on
    (bench.py:153).  Each window is timed between CUDA events with one
    synchronize at its end (`time.perf_counter` on the CPU).  On a card a
    launch captured inside the windows raises.  The runner takes over
    `states`."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    states, calls = warm_up(run, states, batch)
    t = calls[-1][0] + batch
    warmup = len(calls)
    if cuda:
        torch.cuda.synchronize(dev)
    captured = sum(cuda_step.CAPTURED.values())
    executed = cuda_step.executed_launches()
    ms = []
    for _ in range(n_windows):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            states = run(states, t, batch)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            states = run(states, t, batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        calls.append((t, batch))
        t += batch
    captured = sum(cuda_step.CAPTURED.values()) - captured
    if captured:
        raise RuntimeError(f"time_runner: {captured} kernel launches captured "
                           "inside the timed windows")
    now = cuda_step.executed_launches()
    launches = {k: v - executed[k] for k, v in now.items() if v != executed[k]}
    return Windows(ms, [updates_per_coarse * batch / m / 1e3 for m in ms], calls,
                   warmup, launches, states)


def _check(b: Bench, w: Windows, batch: int, n_windows: int, device) -> None:
    """The windows launched what their steps need (on a card) and left
    finite states with rho in (0.5, 1.5)."""
    if torch.device(device).type == "cuda":
        want = {k: v * n_windows
                for k, v in batch_launches(b.statics, batch, b.run.fused2).items()}
        if w.launches != want:
            raise RuntimeError(f"bench: the timed windows executed {w.launches}, "
                               f"their coarse steps need {want}")
    for lvl, st in enumerate(w.states):
        # extrema (NaN propagates through them) rather than an elementwise
        # test, whose temporaries would add ~21 B a cell to the row's peak
        vals = torch.stack([*torch.aminmax(st["rho"]), *torch.aminmax(st["vel"])])
        lo, hi, vlo, vhi = vals.tolist()
        ok = all(np.isfinite([lo, hi, vlo, vhi])) and lo > 0.5 and hi < 1.5
        if not ok:
            raise RuntimeError(f"bench: level {lvl + 1} is not finite or rho left "
                               "(0.5, 1.5) after the timed windows")


def _spread(values: List[float]) -> Tuple[float, float, float]:
    return statistics.median(values), min(values), max(values)


def card(device) -> str:
    """The card's name and power limit (`checks.nvidia_smi`), or "cpu"."""
    return checks.nvidia_smi() if torch.device(device).type == "cuda" else "cpu"


def headline(device="cuda", surface_resolution: int = 25, num_levels: int = 3,
             batch: int = HEADLINE_BATCH, n_windows: int = HEADLINE_WINDOWS,
             builds: int = HEADLINE_BUILDS) -> Dict:
    """The headline's JSON object (module docstring).  The case is built
    `builds` times, each build warmed up and timed over `n_windows` and
    torn down before the next.  `value` = `value_su`, the median over the
    builds of each build's median MLUPS-su; `value_su_min` / `_max` over
    every window of every build; `ms_per_coarse_step` the median over the
    builds of each build's median (`build_ms`); `value_ref` in the
    reference's convention; the kernels each level runs and their
    launches per coarse step; the memory (`memory_fields`) of the build
    that peaked highest."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    window_ms, mlups, warmups, launches, mem = [], [], [], {}, []
    for i in range(builds):
        t0 = time.time()
        base = memory_start(dev)
        b = build_sphere_runner(surface_resolution, num_levels, dev)
        built = time.time() - t0
        w = time_runner(b.run, b.states, b.updates_per_coarse, batch, n_windows, dev)
        _check(b, w, batch, n_windows, dev)
        mem.append(memory_fields(dev, base, hbm_total_patches(
            b.levels, b.statics, b.cfg.precision, dev)))
        window_ms.append(w.ms)
        mlups.append(w.mlups)
        warmups.append(w.warmup)
        for k, v in w.launches.items():
            launches[k] = launches.get(k, 0) + v
        med, lo, hi = _spread(w.mlups)
        print(f"# bench headline build {i + 1} of {builds}: {b.total_cells / 1e6:.3f}M "
              f"cells, {batch * n_windows} steps in {n_windows} windows -> {med:.1f} "
              f"MLUPS-su (median; {lo:.1f} - {hi:.1f}) | build {built:.1f} s",
              file=sys.stderr, flush=True)
        precision, cells, updates, engines = (b.cfg.precision, b.total_cells,
                                              b.updates_per_coarse, b.engines)
        del b, w
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    su = statistics.median(statistics.median(m) for m in mlups)
    every = [v for m in mlups for v in m]
    build_ms = [statistics.median(ms) / batch for ms in window_ms]
    steps = batch * n_windows * builds
    return {
        "metric": f"MLUPS-su, site updates per second (D3Q27 sphere Re~1M, "
                  f"{num_levels} levels, {cells / 1e6:.2f}M cells, "
                  f"{precision} storage / f32 math; median over {builds} builds of "
                  f"each build's median of {n_windows} windows of {batch} coarse "
                  f"steps, {'CUDA events' if cuda else 'host clock'}; value_ref in "
                  "the reference's cells x coarse-steps convention)",
        "unit": "MLUPS",
        "value": su,
        "value_su": su,
        "value_ref": su * cells / updates,
        "value_su_min": min(every),
        "value_su_max": max(every),
        "ms_per_coarse_step": statistics.median(build_ms),
        "builds": builds,
        "build_ms": build_ms,
        "window_ms": window_ms,
        "windows": f"{n_windows} x {batch}",
        "warmup_calls": warmups,
        "cells": cells,
        "updates_per_coarse": updates,
        "engines": engines,
        "launches_per_coarse_step": {k: v / steps for k, v in launches.items()},
        **max(mem, key=lambda m: m["peak_gb"] or 0),
        "device": card(dev),
    }


def memory_start(dev: torch.device) -> Tuple[int, int]:
    """The bytes (allocated, reserved) on the card `dev` once its cache is
    emptied, with its peaks reset: what `memory_fields` measures above;
    (0, 0) on the CPU."""
    if dev.type != "cuda":
        return 0, 0
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)


def memory_fields(dev: torch.device, base: Tuple[int, int], estimate: int) -> Dict:
    """A run's device memory since `memory_start` returned `base`, beside its
    estimate (`solver_dense.hbm_total_patches`, what the card's rule
    reads): `peak_gb` its allocated peak above `base`; `reserved_gb` the
    larger of that peak and what the caching allocator's reservations
    peaked above theirs at the start (in a fresh process the run's
    reserved peak; where earlier runs left free blocks in live segments
    the run may fill them, and this reads its allocated peak); `context_gb`
    what the card holds beyond torch's reservations (the CUDA context);
    `reserve_gb` the card's reserve (`memory.card_reserve`);
    `estimate_over_peak`.  The card's rule holds where estimate + reserve
    covers reserved + context.  None on the CPU but the estimate."""
    out = {"peak_gb": None, "reserved_gb": None, "context_gb": None,
           "reserve_gb": None, "estimate_gb": estimate / 1e9,
           "estimate_over_peak": None}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) - base[0]
        held = max(peak, torch.cuda.max_memory_reserved(dev) - base[1])
        free, total = torch.cuda.mem_get_info(dev)
        out.update(peak_gb=peak / 1e9, reserved_gb=held / 1e9,
                   context_gb=(total - free - torch.cuda.memory_reserved(dev)) / 1e9,
                   reserve_gb=memory.card_reserve(total) / 1e9,
                   estimate_over_peak=estimate / max(peak, 1))
    return out


def _time_row(row: Dict, res: int, dev: torch.device, base: Tuple[int, int]) -> None:
    """Build, time and check one sweep row into `row`; its case, states and
    runner die with this call.  `base`: the bytes (allocated, reserved) on
    the card at the row's start (`memory_start`), which its peaks do not
    count."""
    t0 = time.time()
    b = build_row(res, dev)
    built = time.time() - t0
    cells = b.total_cells
    row.update(cells=cells, label=f"{cells / 1e6:.1f}M", engine=b.engines[0])
    batch = int(np.clip(round(2e9 / cells), 10, 1200))  # bench.py:219
    n_win = 5 if cells < 20e6 else 4
    w = time_runner(b.run, b.states, b.updates_per_coarse, batch, n_win, dev)
    _check(b, w, batch, n_win, dev)
    mlups, lo, hi = _spread(w.mlups)
    mem = memory_fields(dev, base, hbm_total_patches(b.levels, b.statics,
                                                     b.cfg.precision, dev))
    row.update(mlups=mlups, mlups_min=lo, mlups_max=hi, windows=f"{n_win} x {batch}",
               **mem)
    print(f"# sweep res {res}: {row['label']} cells on {row['engine']} -> "
          f"{mlups:.1f} MLUPS (median; {lo:.1f} - {hi:.1f}) | build {built:.1f} s | "
          f"memory estimate {mem['estimate_gb']:.3f} GB"
          + (f", peak {mem['peak_gb']:.3f} GB allocated, {mem['reserved_gb']:.3f} GB "
             f"reserved, context {mem['context_gb']:.3f} GB, estimate / peak "
             f"{mem['estimate_over_peak']:.3f}" if mem["peak_gb"] is not None else ""),
          file=sys.stderr, flush=True)


def sweep_row(res: int, device) -> Dict:
    """One sweep row; a failure is the row's `error`, with `mlups` null.  On
    a card the peaks are reset at the row's start and its memory
    (`memory_fields`) is measured above what was allocated and reserved
    then; the row fails if its teardown leaves more than `TEARDOWN_SLACK`
    allocated above that level."""
    dev = torch.device(device)
    row = {"res": res, "cells": None, "label": None, "mlups": None,
           "mlups_min": None, "mlups_max": None, "windows": None, "engine": None,
           "peak_gb": None, "reserved_gb": None, "context_gb": None,
           "reserve_gb": None, "estimate_gb": None, "estimate_over_peak": None,
           "error": None}
    cuda = dev.type == "cuda"
    base = memory_start(dev)
    try:
        _time_row(row, res, dev, base)
    except Exception as e:  # noqa: BLE001 - the row records it, main exits 1
        row.update(mlups=None, mlups_min=None, mlups_max=None,
                   error=f"{type(e).__name__}: {e}"[:300])
        print(f"# sweep res {res} FAILED: {row['error']}", file=sys.stderr, flush=True)
        traceback.print_exc(file=sys.stderr)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev) - base[0]
        if left > TEARDOWN_SLACK and row["error"] is None:
            row.update(mlups=None, mlups_min=None, mlups_max=None,
                       error=f"teardown left {left} bytes allocated")
    return row


def sweep(res_list: Sequence[int] = SWEEP_RES, device="cuda",
          out_path: Optional[str] = SWEEP_OUT) -> List[Dict]:
    """The sweep's rows, written to `out_path` (with the card and the
    torch version) after each row."""
    dev = resolve_device(device)
    doc = {"device": card(dev), "torch": torch.__version__, "rows": []}
    for res in res_list:
        doc["rows"].append(sweep_row(res, dev))
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(doc, fh, indent=1)
    return doc["rows"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="run the single-level rows first, into --out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=SWEEP_OUT, help="the sweep's JSON file")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    dev = resolve_device(args.device)
    failed = False
    if args.sweep:
        failed = any(r["error"] for r in sweep(SWEEP_RES, dev, args.out))
    print(json.dumps(headline(dev)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

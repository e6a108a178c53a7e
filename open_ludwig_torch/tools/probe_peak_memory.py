"""What the device holds at a run's peak, by the line that allocated it.

    python -m open_ludwig_torch.tools.probe_peak_memory [--res 25,45]
        [--headline] [--schedules k1,fused,k5] [--windows 1]

For the bench's sweep rows at the given surface resolutions (`bench.
build_row`) and, with `--headline`, the headline's case (`bench.
build_sphere_runner`), each schedule is built from an empty card and run as
the bench runs it (`bench.time_runner`: warm-up calls until every step is a
graph replay, then `--windows` windows of the row's batch), under
`torch.cuda.memory._record_memory_history` (Python stacks):

  "k1"     every level on its engine with K5 replaced by K1, unfused
  "fused"  the same with the finest level's sub-step pairs on K3
  "k5"     a single level forced in place (K5), skipped on several levels

From the allocator's trace it finds the moment the bytes allocated since
the case's start peaked, and groups what was live then by the first frame
in the package that allocated it (`peak_live`).  Prints one JSON line per
case and schedule: the peak above the start (`torch.cuda.max_memory_
allocated`, and the trace's), bytes a cell, the device-memory estimate of
`solver_dense.hbm_total_patches` for the statics run and its ratio to the
peak, and the live groups at the peak, largest first.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

SCHEDULES = ("k1", "fused", "k5")
MAX_ENTRIES = 1_000_000  # the allocator trace's ring


def _site(frames: Sequence[Dict]) -> str:
    """The innermost frame of the package among `frames` (innermost first),
    as "file:line function", or the innermost frame of all."""
    for fr in frames:
        name = str(fr.get("filename", ""))
        if "open_ludwig_torch" in name:
            short = name[name.rindex("open_ludwig_torch"):]
            return f"{short}:{fr.get('line')} {fr.get('name')}"
    if frames:
        fr = frames[0]
        return f"{fr.get('filename')}:{fr.get('line')} {fr.get('name')}"
    return "unknown"


def peak_live(trace: Iterable[Dict]) -> Tuple[int, List[Dict]]:
    """(peak, groups) from an allocator trace (`torch.cuda.memory._snapshot()
    ["device_traces"][i]`: entries with "action", "addr", "size", "frames").
    The bytes allocated by the trace's "alloc" entries and not yet freed
    ("free_requested", or "free_completed" where no request was logged)
    peak at some entry; `groups` is what was live there, summed by
    allocating site (`_site`) and sorted by bytes.  Frees of blocks
    allocated before the trace began are ignored."""
    live: Dict[int, Tuple[int, str]] = {}
    total = peak = 0
    at_peak: Dict[int, Tuple[int, str]] = {}
    for ev in trace:
        act, addr = ev.get("action"), int(ev.get("addr", 0))
        if act == "alloc":
            live[addr] = (int(ev["size"]), _site(ev.get("frames") or []))
            total += live[addr][0]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif act in ("free_requested", "free_completed") and addr in live:
            total -= live.pop(addr)[0]
    groups: Dict[str, Dict] = {}
    for size, site in at_peak.values():
        g = groups.setdefault(site, {"site": site, "bytes": 0, "blocks": 0})
        g["bytes"] += size
        g["blocks"] += 1
    return peak, sorted(groups.values(), key=lambda g: -g["bytes"])


def _schedule(b, schedule: str):
    """(statics, fuse2) of `schedule` on a built case, or None where it
    does not apply."""
    if schedule == "k5":
        if len(b.statics) != 1:
            return None
        return [{**b.statics[0], "engine": "inplace", "engine_why": "forced"}], False
    statics = [{**s, "engine": "k1", "engine_why": "forced"}
               if s["engine"] == "inplace" else s for s in b.statics]
    return statics, schedule == "fused"


def probe(label: str, build, schedule: str, windows: int, dev) -> Optional[Dict]:
    from .. import bench
    from ..solver_dense import hbm_total_patches, make_batch_runner_dense

    gc.collect()
    torch.cuda.synchronize(dev)  # the card's context, before the counters are read
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(max_entries=MAX_ENTRIES, stacks="python")
    try:
        b = build()
        sched = _schedule(b, schedule)
        if sched is None:
            return None
        statics, fuse2 = sched
        run = make_batch_runner_dense(b.cfg, b.params, b.levels, statics, fuse2=fuse2)
        states = b.states  # the runner takes the list over
        cells = b.total_cells
        batch = (bench.HEADLINE_BATCH if len(b.levels) > 1
                 else int(np.clip(round(2e9 / cells), 10, 1200)))
        w = bench.time_runner(run, states, b.updates_per_coarse, batch, windows, dev)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    traced, groups = peak_live(snap["device_traces"][index])
    est = hbm_total_patches(b.levels, statics, b.cfg.precision, dev)
    out = {"case": label, "schedule": schedule, "cells": cells,
           "engines": [s["engine"] for s in statics], "fuse2": fuse2,
           "batch": batch, "windows": windows,
           "ms_per_coarse_step": float(np.median(w.ms)) / batch,
           "peak_bytes": peak, "traced_peak_bytes": traced,
           "peak_b_per_cell": peak / cells, "estimate_bytes": est,
           "estimate_over_peak": est / max(peak, 1),
           "groups": [{**g, "b_per_cell": g["bytes"] / cells} for g in groups[:12]]}
    del run, states, w, b, snap
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", default="25,45")
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--schedules", default=",".join(SCHEDULES))
    ap.add_argument("--windows", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_peak_memory: needs a GPU")
    from .. import bench

    dev = torch.device("cuda", 0)
    card = bench.card(dev)
    cases = [(f"row res {r}", (lambda r=r: bench.build_row(r, dev)))
             for r in (int(v) for v in args.res.split(",") if v)]
    if args.headline:
        cases.append(("headline", lambda: bench.build_sphere_runner(device=dev)))
    lines = []
    for label, build in cases:
        for schedule in args.schedules.split(","):
            line = probe(label, build, schedule, args.windows, dev)
            if line is None:
                continue
            line["device"] = card
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()

"""The bench's sweep rows on the card's schedule and on the JAX package's.

    python -m open_ludwig_torch.tools.probe_sweep_rows [--res 25,34,45,52,57]
        [--windows 3] [--batch N] [--device cuda|cpu]

For each surface resolution, the sweep row of `open_ludwig_torch.bench`
(`bench.ROW_CASE`: one level, bf16, `domain_tile_snap`) and the same case
without the snap (res 25: the 10.8M-cell level 232x216x216 of
`chip_smoke.py` phases 6 and 13), each a finest K1 level by the card's
rule where it fits the card, timed through `bench.time_runner` (the row's
batch, graphed on a card) on three schedules, in turns own, fused, k5, k5,
fused, own, each turn from rest:

  "own"    the batch runner's defaults: the card's rule (`ops.engine.
           card_engines`, the card's capacity), unfused: K1 -> K2 where the
           row fits the card
  "fused"  the JAX package's schedule on its 1-D kernel: K3 pairs + K2
           (engine K1, `fuse2=True`)
  "k5"     the level forced in place: K5 + K2 (the JAX package's choice
           for the large rows)

Prints one JSON line per case: the level's dims, its engine by the card's
rule, K5's layout on a card, and per turn the median ms per coarse step
and ns per cell update.  `main` returns the lines.  `--device cpu` runs the plain PyTorch path at a small size (the
tests).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import bench, checks
from ..cases import make_case_sphere
from ..config import load_case_config
from ..ops.cuda_step import inplace_layout
from ..runner import resolve_device
from ..solver_dense import build_patch_statics, init_patch_state, make_batch_runner_dense

TURNS = ("own", "fused", "k5", "k5", "fused", "own")
_FORCED = {"fused": "k1", "k5": "inplace"}  # the level's engine on a schedule


def _turn(case, schedule: str, batch: int, windows: int, dev) -> float:
    """Median ms per coarse step of one schedule's runner from rest."""
    cfg, params, levels, statics = case
    if schedule in _FORCED:
        statics = [{**s, "engine": _FORCED[schedule], "engine_why": "forced"}
                   for s in statics]
    run = make_batch_runner_dense(cfg, params, levels, statics,
                                  fuse2=schedule == "fused")
    states = [init_patch_state(p, cfg.precision, dev) for p in levels]
    w = bench.time_runner(run, states, levels[0].n_cells, batch, windows, dev)
    return statistics.median(w.ms) / batch


def probe(res: int, snap: bool, windows: int, batch: Optional[int], dev) -> Dict:
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        make_case_sphere(tmp, "1M", surface_resolution=res,
                         **{**bench.ROW_CASE, "domain_tile_snap": snap})
        cfg = load_case_config(tmp)
        _, params, levels = checks.case_levels(cfg)
    statics = build_patch_statics(cfg, levels, dev)
    (level,), (static,) = levels, statics
    cells = level.n_cells
    batch = batch or int(np.clip(round(2e9 / cells), 10, 1200))
    out = {"res": res, "snap": snap, "dims": list(level.interior), "cells": cells,
           "engine": static["engine"],
           "batch": batch, "windows": windows, "build_s": time.time() - t0,
           "turns": []}
    if dev.type == "cuda":
        out["layout"] = inplace_layout(*level.interior, dev, 2)
    for schedule in TURNS:
        ms = _turn((cfg, params, levels, statics), schedule, batch, windows, dev)
        out["turns"].append({"schedule": schedule, "ms": ms,
                             "ns_per_cell": ms * 1e6 / cells})
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", default="25,34,45,52,57")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None,
                    help="coarse steps a call (default: the sweep row's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = bench.card(dev)
    lines = []
    for res in (int(r) for r in args.res.split(",")):
        cases = [probe(res, snap, args.windows, args.batch, dev)
                 for snap in (True, False)]
        for line in cases:
            line["device"] = card
            print(json.dumps(line), flush=True)
        lines += cases
    return lines


if __name__ == "__main__":
    main()

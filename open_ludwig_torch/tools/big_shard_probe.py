"""The reference's "216M-cell" row on an x mesh: 2 virtual slabs of one
card, bit-equal to one device.

    python -m open_ludwig_torch.tools.big_shard_probe [--res 68] [--steps 2]
        [--device cuda|cpu] [--cases DIR]

The port's counterpart of `tools/big_shard_probe.py`.  It builds the row
of `plan_216m` (the single-level bf16 sphere at N = `--res`), runs
`--steps` coarse steps from one perturbed state on one device and on
2 x slabs (`parallel.patch_shard`: with `--device cuda` a virtual mesh
`XMesh([cuda:0] * 2)` of the one card, with `--device cpu` 2 CPU slabs),
each timed, and checks that the sharded run's final state is finite and
equal to the one-device run's bit for bit.  Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Optional, Sequence

import torch

from .plan_216m import build_row, card, perturbed_states, row_case

SLABS = 2  # x slabs of the virtual mesh


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from ..ops import cuda_step
    from ..parallel.patch_shard import XMesh, shard_states, slab_bounds
    from ..runner import resolve_device
    from ..solver_dense import build_patch_statics, make_batch_runner_dense

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=68)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cases", default="validation_runs")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    case = row_case(os.path.join(args.cases, f"row_{args.res}"), args.res, args.steps)
    cfg, params, levels, statics, build_s = build_row(case, dev)
    mesh = XMesh([dev] * SLABS)
    statics_sh = build_patch_statics(cfg, levels, dev, x_mesh=mesh)
    cells = sum(p.n_cells for p in levels)
    print(f"[big shard] {cells / 1e6:.1f}M cells {tuple(levels[0].interior)}, "
          f"{cfg.precision}, kernel {statics[0]['engine']}; host build {build_s:.1f} s"
          f" | {SLABS} slabs of x {slab_bounds(levels[0].interior[0], SLABS)}"
          f" on {dev}", flush=True)

    start = perturbed_states(levels, cfg.precision, 11, dev)
    one = make_batch_runner_dense(cfg, params, levels, statics)
    sync()
    t0 = time.time()
    want = one([{**s, "f": s["f"].clone()} for s in start], 1, args.steps)
    sync()
    one_s = time.time() - t0
    del one, statics
    sh = shard_states(start, mesh)
    del start
    two = make_batch_runner_dense(cfg, params, levels, statics_sh, x_mesh=mesh)
    cuda_step.reset_launches()
    sync()
    t0 = time.time()
    sh = two(sh, 1, args.steps)
    sync()
    two_s = time.time() - t0
    launches = {k: v for k, v in cuda_step.executed_launches().items() if v}

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    equal = finite = True
    for lvl, st in enumerate(sh):
        b = slab_bounds(levels[lvl].interior[0], SLABS)
        for key, lead in (("f", 1), ("rho", 0), ("vel", 1)):
            for i, part in enumerate(st[key]):
                ref = want[lvl][key].narrow(lead, b[i], b[i + 1] - b[i])
                equal &= bool(torch.equal(bits(part), bits(ref)))
                finite &= bool(torch.isfinite(part).all())
    row = {"cells": cells, "interior": list(levels[0].interior), "slabs": SLABS,
           "steps": args.steps, "precision": cfg.precision,
           "engine": statics_sh[0]["engine"], "launches": launches,
           "finite": finite, "equal_to_one_device": equal,
           "one_device_s": one_s, "sharded_s": two_s, "build_s": build_s,
           "card": card(), "device": str(dev),
           "note": "wall seconds of the steps after the set-up, first calls "
                   "included (not a rate)"}
    print(f"[big shard] {args.steps} coarse steps: sharded final state finite "
          f"{finite}, bit-equal to one device {equal} | one device {one_s:.2f} s, "
          f"{SLABS} slabs {two_s:.2f} s | launches {launches}", flush=True)
    print(json.dumps(row), flush=True)
    if not (finite and equal):
        raise RuntimeError("the sharded row is not finite or not one device's")
    return row


if __name__ == "__main__":
    main()

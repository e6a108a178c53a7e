"""Stress mapping against momentum exchange on a sphere flow.

    python -m open_ludwig_torch.tools.mem_probe [--res 25] [--steps 6000]
        [--levels 3] [--device cuda|cpu] [--out DIR]

The port's counterpart of `tools/mem_probe.py`, the MEM cross-check the
wing control-volume study motivated (VALIDATION.md): the Re 2.67e5 sphere
(`cases.make_case_sphere("266K")`) at N = `--res` on `--levels` levels,
run `--steps` coarse steps from rest (ramp a quarter of them), then the
finest level's forces by stress mapping (`ops.forces.compute_aerodynamics`)
and by momentum exchange (`compute_aerodynamics_mem`) on the same state.
`build_dense_run` is the set-up `mem_convergence` and `wing_cv_probe`
share.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
from typing import Optional, Sequence

import numpy as np
import torch

BATCH = 2000  # coarse steps per call of the batch runner


def build_dense_run(case_dir: str, device="cuda"):
    """The case's (cfg, mesh, params, levels, rest states, batch runner,
    stress-mapping context, MEM context or None) on `device` (raises
    without CUDA when the card is asked for)."""
    from ..config import load_case_config
    from ..core.patch import build_patches
    from ..geometry import load_mesh
    from ..ops import storage
    from ..ops.forces import make_force_context_dense, make_mem_context
    from ..runner import resolve_device
    from ..scaling import compute_domain_params
    from ..solver_dense import (build_patch_statics, init_patch_state,
                                make_batch_runner_dense)

    dev = resolve_device(device)
    cfg = load_case_config(case_dir)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = build_patch_statics(cfg, levels, dev)
    states = [init_patch_state(p, cfg.precision, dev) for p in levels]
    run = make_batch_runner_dense(cfg, params, levels, statics)
    # the function's default, two-point wall extrapolation on, as the JAX
    # tools build it (the runner follows `forces.extrapolate`, off by default)
    fctx = make_force_context_dense(mesh, levels[-1], params, device=dev)
    mctx = make_mem_context(levels[-1], params, mesh,
                            g_storage=storage.f_dtype(cfg.precision) == torch.bfloat16,
                            device=dev)
    return cfg, mesh, params, levels, states, run, fctx, mctx


def advance(run, states, t0: int, n: int):
    """Coarse steps t0 .. t0 + n - 1 in calls of at most BATCH steps."""
    for t in range(t0, t0 + n, BATCH):
        states = run(states, t, min(BATCH, t0 + n - t))
    return states


def main(argv: Optional[Sequence[str]] = None):
    from ..cases import make_case_sphere
    from ..ops.forces import compute_aerodynamics, compute_aerodynamics_mem

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=25)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_runs")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    case = os.path.join(args.out, "mem_probe")
    shutil.rmtree(case, ignore_errors=True)
    make_case_sphere(case, "266K", surface_resolution=args.res,
                     num_levels=args.levels, steps=args.steps,
                     ramp_steps=max(args.steps // 4, 1), output_freq=10**9,
                     diag_freq=10**9)
    cfg, mesh, params, levels, states, run, fctx, mctx = build_dense_run(
        case, args.device)
    states = advance(run, states, 1, args.steps)
    fr = compute_aerodynamics(states[-1], fctx)
    print(f"[mapping] Cd={fr.Cd:+.4f} Cl={fr.Cl:+.4f} Fx={fr.Fx:+.3e} | res "
          f"{args.res}, {len(levels)} levels, {args.steps} steps, device {args.device}")
    if mctx is None:
        print("[mom-ex ] no links")
        return fr, None
    fm = compute_aerodynamics_mem(states[-1], mctx)
    print(f"[mom-ex ] Cd={fm.Cd:+.4f} Cl={fm.Cl:+.4f} Fx={fm.Fx:+.3e} "
          f"({mctx.n_links} links)  rest_F={np.asarray(mctx.rest_F)}", flush=True)
    return fr, fm


if __name__ == "__main__":
    main()

"""MEM resolution convergence on the sphere: time-averaged MEM against
mapped Cd at N = 25 / 40 / 55.

    python -m open_ludwig_torch.tools.mem_convergence [--res 25,40,55]
        [--base-steps 6000] [--device cuda|cpu] [--out MEM_CONVERGENCE.json]

The port's counterpart of `tools/mem_convergence.py`.  Momentum exchange
integrates over the voxelized body, whose staircase surface sits 0.3-1.4
cells proud of the triangles; this sweeps N at Re 2.67e5 (3 levels) and
reports, per N, the mean over the last quarter of the run (samples every
max(100, steps/40) coarse steps) of the MEM and the mapped Cd, MEM's Cl
and their relative gap.  Each N runs base_steps x N / 25 coarse steps, the
same physical time.  The reference measured Cd 0.447 at the end of its
6000-step Re 2.67e5 run (reference: RESULTS_SPHERE_RE266K.txt:236).  Rows
go to `--out` as JSON (rewritten after each N) and one line each to stdout.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

from .mem_probe import build_dense_run

REF_CD = 0.447  # reference: RESULTS_SPHERE_RE266K.txt:236


def run_res(res: int, base_steps: int, device, case: str) -> Dict:
    from ..cases import make_case_sphere
    from ..ops.forces import compute_aerodynamics, compute_aerodynamics_mem

    steps = int(base_steps * res / 25)  # the same physical time at every N
    shutil.rmtree(case, ignore_errors=True)
    make_case_sphere(case, "266K", surface_resolution=res, num_levels=3, steps=steps,
                     ramp_steps=max(steps // 4, 1), output_freq=10**9,
                     diag_freq=10**9)
    cfg, mesh, params, levels, states, run, fctx, mctx = build_dense_run(case, device)
    if mctx is None or mctx.n_links == 0:
        raise RuntimeError(f"no momentum-exchange links at N={res}")
    # the transient, then forces every `samp` steps over the last quarter
    t_avg0 = int(steps * 0.75)
    samp = max(100, steps // 40)
    cd_map, cd_mem, cl_mem = [], [], []
    t = 0
    while t < steps:
        b = min(samp, steps - t) if t >= t_avg0 else t_avg0 - t
        states = run(states, t + 1, b)
        t += b
        if t > t_avg0:
            fr = compute_aerodynamics(states[-1], fctx)
            fm = compute_aerodynamics_mem(states[-1], mctx)
            cd_map.append(float(fr.Cd))
            cd_mem.append(float(fm.Cd))
            cl_mem.append(float(fm.Cl))
    return {
        "res": res, "steps": steps, "levels": len(levels), "n_samples": len(cd_mem),
        "n_links": int(mctx.n_links), "cd_mapped": float(np.mean(cd_map)),
        "cd_mem": float(np.mean(cd_mem)), "cd_mem_std": float(np.std(cd_mem)),
        "cl_mem": float(np.mean(cl_mem)),
        "mem_vs_mapped_pct": float(100 * (np.mean(cd_mem) - np.mean(cd_map))
                                   / max(abs(np.mean(cd_map)), 1e-9)),
        "cd_reference": REF_CD, "device": device,
    }


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", default="25,40,55", help="comma-separated N")
    ap.add_argument("--base-steps", type=int, default=6000,
                    help="coarse steps at N = 25 (scaled by N / 25)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="MEM_CONVERGENCE.json")
    ap.add_argument("--cases", default="validation_runs",
                    help="directory of the case directories")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    rows = []
    for res in (int(r) for r in args.res.split(",")):
        rows.append(run_res(res, args.base_steps, args.device,
                            os.path.join(args.cases, f"mem_conv_{res}")))
        print(json.dumps(rows[-1]), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()

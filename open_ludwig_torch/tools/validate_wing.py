"""Wing validation: Cl(5 deg) > Cl(0 deg) with plausible Cd.

    python -m open_ludwig_torch.tools.validate_wing [--res 48] [--steps 12000]
        [--device cuda|cpu] [--out DIR]

The port's counterpart of `tools/validate_wing.py`: the shipped NACA0012
wing cases (`CASES/wing_0deg`, `CASES/wing_5deg`) at one matched
resolution and a long force window (the second half of the run), held to
the ordering the geometry implies: lift at 5 deg clearly above lift at
0 deg (by twice the larger standard error), with |Cd| in (0.002, 0.25).
The reference ships no wing force targets (its wing cases are set up for
N=1100 and ship no results), so ordering and band are the check.
Regime, as the JAX tool's (all measured there, VALIDATION.md): res 24
leaves ~3 cells across the 12%-thick section and Cl means nothing;
laminar Re 1e4 shows the low-Re NACA0012 negative-lift anomaly at small
alpha; so WMLES at Re 6.7e5 (10 m/s, wall model on), where the lift
ordering is robust and the slope, resolution-limited, is far below
lifting-line.  Exit code 0 when both checks pass, else 1.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import os
import shutil
import statistics as st
import sys
from typing import Optional, Sequence

from ..checks import copy_case


def run_case(name: str, res: int, steps: int, window: int, device="cuda",
             out: str = "validation_runs"):
    """(mean Cl, sd Cl, mean Cd, n) over the rows after steps - window."""
    from ..config import load_case_config
    from ..runner import resolve_device, solve_case

    resolve_device(device)
    case = os.path.join(out, f"valwing_{name}")
    shutil.rmtree(case, ignore_errors=True)
    copy_case(name, case, {
        "basic.surface_resolution": res, "basic.flow.velocity": 10.0,
        "advanced.high_re.wall_model.enabled": True,
        "basic.simulation.steps": steps,
        "basic.simulation.ramp_steps": min(2000, steps // 4),
        "basic.simulation.output_freq": 10 * steps,
        # forces every 100 steps; a run under 1000 steps (a smoke run) keeps ten rows
        "advanced.diagnostics.freq": min(100, max(steps // 10, 1))})
    c = load_case_config(case)
    solve_case(c, device=device)
    with open(os.path.join(c.output_path, "forces.csv")) as f:
        rows = list(csv.DictReader(f))
    w = [r for r in rows if int(r["Step"]) > steps - window]
    cl = [float(r["Cl"]) for r in w]
    cd = [float(r["Cd"]) for r in w]
    return (st.mean(cl), st.stdev(cl) if len(cl) > 1 else 0.0, st.mean(cd), len(w))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_runs")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    window = args.steps // 2
    kw = dict(device=args.device, out=args.out)
    cl0, s0, cd0, n0 = run_case("wing_0deg", args.res, args.steps, window, **kw)
    cl5, s5, cd5, n5 = run_case("wing_5deg", args.res, args.steps, window, **kw)
    dcl_dalpha = (cl5 - cl0) / math.radians(5.0)
    print(f"[WING 0deg] Cl = {cl0:+.4f} +- {s0:.4f}  Cd = {cd0:.4f} (n={n0})")
    print(f"[WING 5deg] Cl = {cl5:+.4f} +- {s5:.4f}  Cd = {cd5:.4f} (n={n5})")
    print(f"[WING] dCl/dalpha = {dcl_dalpha:.2f} /rad  (2pi = 6.28) | res {args.res},"
          f" {args.steps} steps, window {args.steps - window}+ | device {args.device}")
    ok = cl5 > cl0 + 2.0 * max(s0, s5) / max(n0, 1) ** 0.5
    cd_ok = 0.002 < abs(cd0) < 0.25 and 0.002 < abs(cd5) < 0.25
    print(f"[WING] Cl ordering: {'PASS' if ok else 'FAIL'} | "
          f"Cd plausibility: {'PASS' if cd_ok else 'FAIL'}", flush=True)
    return 0 if (ok and cd_ok) else 1


if __name__ == "__main__":
    sys.exit(main())

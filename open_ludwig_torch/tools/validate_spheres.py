"""Window-matched sphere Cd against the reference's three validated runs.

    python -m open_ludwig_torch.tools.validate_spheres [266K] [1M] [10M]
        [--device cuda|cpu] [--out DIR] [--steps N] [--window-from S]
        [--resume]

The port's counterpart of `tools/validate_spheres.py`.  Each regime runs
the repo's shipped case (`CASES/sphere_re266k`, `sphere_re1m`,
`sphere_re10m`: an icosphere of 5,120 triangles; the reference's own
`ball1m.stl` of 20,480 is not in the repo) at the regime's speed and
resolution with the wall model on, as in the reference's runs
(reference: RESULTS_SPHERE_RE{266K,1M,10M}.txt):

  266K: U=4 m/s,  N=25, 3 levels  -> ref late-window Cd 0.383 +- 0.040
  1M:   U=14.8,   N=25, 3 levels  -> ref late-window Cd 0.378 +- 0.031
  10M:  U=148,    N=55, 4 levels  -> ref late-window Cd 0.332 +- 0.023

The targets are the mean over the last 2000 steps of each reference
console log.  The flows are chaotic, so a window of thousands of
post-transient steps is the comparison (VALIDATION.md: 6000+ or 8000+ of
18,000-36,000): `--window-from S` averages the force rows with
S < step <= the last step; without it, the last 2000 steps.

The case directory is `--out`/val_<regime>; `--resume` continues from its
latest checkpoint (written at every quarter of the run), so a run cut at
the end of one call goes on in the next.  Prints one `[VALIDATE ...]`
line per regime: mean Cd +- sd, Cl, the number of rows n and the standard
error, the STL's triangle count, the reference and the deviation.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import shutil
import statistics as st
import sys
from typing import Dict, Optional, Sequence

from ..checks import copy_case

REGIMES = {
    "266K": dict(case="sphere_re266k", velocity=4.0, surface_resolution=25,
                 steps=6000, ref_cd=0.3832, ref_sd=0.0397),
    "1M": dict(case="sphere_re1m", velocity=14.8, surface_resolution=25,
               steps=12000, ref_cd=0.3780, ref_sd=0.0313),
    "10M": dict(case="sphere_re10m", velocity=148.0, surface_resolution=55,
                steps=12000, ref_cd=0.3320, ref_sd=0.0228),
}
WINDOW = 2000  # steps


def make_case(regime: str, out_dir: str, **extra) -> str:
    """The regime's case directory: the shipped case's STL and config with
    the regime's speed, resolution and steps, the wall model on, no flow
    files, forces every 200 steps, a checkpoint at every quarter of the
    run (`resume`: continue from the latest); `overrides` sets dotted
    config keys."""
    r = REGIMES[regime]
    steps = int(extra.get("steps", r["steps"]))
    return copy_case(r["case"], out_dir, {
        "basic.flow.velocity": r["velocity"],
        "basic.surface_resolution": r["surface_resolution"],
        "basic.simulation.steps": steps,
        "basic.simulation.ramp_steps": 2000,
        "basic.simulation.output_freq": 10 * steps,  # no flow file during the run
        "advanced.high_re.wall_model.enabled": True,
        # forces every 200 steps; a run under 2000 steps (a smoke run) keeps ten rows
        "advanced.diagnostics.freq": min(200, max(steps // 10, 1)),
        "advanced.checkpoint": {"freq": max(steps // 4, 1),
                                "resume": bool(extra.get("resume", False))},
        **extra.get("overrides", {})})


def window_stats(forces_csv: str, last_step: int, window: int = WINDOW):
    """(mean Cd, sd Cd, mean Cl, n) over the rows last_step - window < Step
    <= last_step: bounded on both sides, so an offset window into a longer
    run (re10m_ci's r3) measures the window it names."""
    with open(forces_csv) as f:
        rows = list(csv.DictReader(f))
    w = [r for r in rows if last_step - window < int(r["Step"]) <= last_step]
    cds = [float(r["Cd"]) for r in w]
    cls = [float(r["Cl"]) for r in w]
    return (st.mean(cds), st.stdev(cds) if len(cds) > 1 else 0.0,
            st.mean(cls), len(w))


def run_regime(regime: str, tag: str = "", device="cuda", out: str = "validation_runs",
               window_from: Optional[int] = None, resume: bool = False,
               **extra) -> Dict:
    """Run one regime through `runner.solve_case` and print its line."""
    from ..config import load_case_config
    from ..geometry import load_mesh
    from ..runner import resolve_device, solve_case

    resolve_device(device)  # no CUDA: raise before any set-up
    case = os.path.join(out, f"val_{regime}{tag}")
    if not resume:
        shutil.rmtree(case, ignore_errors=True)
    make_case(regime, case, resume=resume, **extra)
    cfg = load_case_config(case)
    res = solve_case(cfg, device=device)
    r = REGIMES[regime]
    steps = cfg.steps
    window = min(WINDOW, steps) if window_from is None else steps - int(window_from)
    cd, sd, cl, n = window_stats(os.path.join(cfg.output_path, "forces.csv"),
                                 steps, window)
    n_tri = load_mesh(cfg.stl_path, scale=cfg.stl_scale).n_triangles
    dev = (cd - r["ref_cd"]) / r["ref_cd"] * 100
    se = sd / max(n, 1) ** 0.5
    print(f"[VALIDATE {regime}{tag}] Cd = {cd:.4f} +- {sd:.4f} (Cl {cl:+.3f}, n={n},"
          f" stderr {se:.4f}, window {steps - window}+ of {steps} steps, STL "
          f"{os.path.basename(cfg.stl_path)} {n_tri} triangles) | ref "
          f"{r['ref_cd']:.4f} +- {r['ref_sd']:.4f} | dev {dev:+.1f}%", flush=True)
    return {"regime": regime + tag, "cd": cd, "sd": sd, "cl": cl, "n": n,
            "stderr": se, "window_from": steps - window, "steps": steps,
            "triangles": n_tri, "dev_pct": dev, "resume_step": res.resume_step,
            "device": device, "forces_csv": os.path.join(cfg.output_path,
                                                         "forces.csv")}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("regimes", nargs="*", metavar="REGIME",
                    help="266K, 1M and/or 10M (default: all three)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_runs",
                    help="directory of the case directories val_<regime>")
    ap.add_argument("--steps", type=int, default=None,
                    help="coarse steps (default: the regime's)")
    ap.add_argument("--window-from", type=int, default=None,
                    help="average the rows after this step (default: the last 2000)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the case directory's latest checkpoint")
    ap.add_argument("--surface-resolution", type=int, default=None,
                    help="cut the regime's N (a smoke run; not a validation)")
    args = ap.parse_args(argv)
    for regime in args.regimes:
        if regime not in REGIMES:
            ap.error(f"unknown regime {regime!r}; use {', '.join(REGIMES)}")
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    extra = {}
    if args.steps is not None:
        extra["steps"] = args.steps
    if args.surface_resolution is not None:
        extra["overrides"] = {"basic.surface_resolution": args.surface_resolution}
    return [run_regime(regime, device=args.device, out=args.out,
                       window_from=args.window_from, resume=args.resume, **extra)
            for regime in (args.regimes or ["266K", "1M", "10M"])]


if __name__ == "__main__":
    main()

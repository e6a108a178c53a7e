"""Re10M Cd margin study: realization scatter around the window-matched run.

    python -m open_ludwig_torch.tools.re10m_ci [r1] [r2] [r3]
        [--device cuda|cpu] [--out DIR] [--steps N]
        [--regime 10M] [--window-from S]

The port's counterpart of `tools/re10m_ci.py`, over the port's
`validate_spheres` (the shipped `CASES/sphere_re10m`, N=55, 4 levels,
WMLES):

  r1: the validated configuration, 12000 steps (window-matched run)
  r2: an independent realization: u_lattice 0.03 -> 0.0295 perturbs the
      discrete trajectory (same Re, same resolution; dt shifts 1.7%) so
      the chaotic wake decorrelates from r1
  r3: r1's configuration run twice as long (24000 steps); the last-2000
      window at every 2000-step offset past r1's length (14000 on) gives
      the within-realization window scatter

`--regime` runs the same realizations of another regime of
`validate_spheres` (the second realization a deviation outside the 5%
band gets before it is called a fault), and `--window-from S` averages
r1's and r2's rows after step S instead of their last 2000 steps.

Prints each run's window Cd and the combined mean with its CI.  r3's
consecutive windows of one realization are autocorrelated, so they
collapse into ONE realization-level sample (their mean) before the CI; at
these small n the CI uses the Student-t quantile for n-1 degrees of
freedom, not z = 1.96.  The reference's own late window is 0.332 +- 0.023
(reference: RESULTS_SPHERE_RE10M.txt:285-288).
"""

from __future__ import annotations

import argparse
import logging
import statistics as st
import sys
from typing import List, Optional, Sequence, Tuple

from .validate_spheres import REGIMES, WINDOW, run_regime, window_stats

# two-sided 95% Student-t quantiles by degrees of freedom
T95 = {1: 12.71, 2: 4.30, 3: 3.18, 4: 2.78, 5: 2.57, 6: 2.45, 7: 2.36}


def t_ci(cds: Sequence[float]) -> Tuple[float, float, float, float]:
    """(mean, half-width of the 95% t-CI of the mean, sample sd, t) of the
    realization-level samples `cds` (at least two)."""
    t95 = T95.get(len(cds) - 1, 2.0)
    mean, sdev = st.mean(cds), st.stdev(cds)
    return mean, t95 * sdev / len(cds) ** 0.5, sdev, t95


def r3_lasts(steps: int) -> List[int]:
    """The ends of r3's windows when r1 runs `steps`: r3 runs 2 * steps and
    replays r1's trajectory, so its windows start past r1's last step."""
    return list(range(steps + WINDOW, 2 * steps + 1, WINDOW))


def r3_windows(forces_csv: str, last_steps: Sequence[int]) -> List[float]:
    """r3's window means, one per window end, stopping at the first window
    the run did not reach."""
    out = []
    for last in last_steps:
        try:
            cd, sd, cl, n = window_stats(forces_csv, last, WINDOW)
        except st.StatisticsError:
            break  # the run ended before this window: no row in it
        out.append(cd)
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[str, float, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", metavar="RUN", help="r1, r2 and/or r3")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_runs")
    ap.add_argument("--steps", type=int, default=REGIMES["10M"]["steps"],
                    help="steps of r1 and r2 (r3 runs twice as many)")
    ap.add_argument("--surface-resolution", type=int, default=None,
                    help="cut N (a smoke run; not a validation)")
    ap.add_argument("--regime", default="10M", choices=sorted(REGIMES))
    ap.add_argument("--window-from", type=int, default=None,
                    help="r1's and r2's window: the rows after this step")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    which = args.runs or ["r1", "r2", "r3"]
    for run in which:
        if run not in ("r1", "r2", "r3"):
            ap.error(f"unknown run {run!r}; use r1, r2, r3")
    common = dict(device=args.device, out=args.out)
    regime = args.regime
    res_over = ({} if args.surface_resolution is None
                else {"basic.surface_resolution": args.surface_resolution})
    ref_cd = REGIMES[regime]["ref_cd"]
    samples = []
    if "r1" in which:
        r = run_regime(regime, tag="_r1", steps=args.steps, overrides=res_over,
                       window_from=args.window_from, **common)
        samples.append((f"r1@{args.steps}", r["cd"], r["sd"]))
    if "r2" in which:
        r = run_regime(regime, tag="_r2", steps=args.steps, overrides={
            **res_over, "advanced.numerics.u_lattice": 0.0295},
            window_from=args.window_from, **common)
        samples.append((f"r2@{args.steps}", r["cd"], r["sd"]))
    if "r3" in which:
        r = run_regime(regime, tag="_r3", steps=2 * args.steps, overrides=res_over,
                       **common)
        lasts = r3_lasts(args.steps)
        wins = r3_windows(r["forces_csv"], lasts)
        for last, cd in zip(lasts, wins):
            print(f"[WINDOW r3@{last}] Cd = {cd:.4f} (dev "
                  f"{(cd - ref_cd) / ref_cd * 100:+.1f}%)", flush=True)
        if wins:
            samples.append(("r3(window-mean)", st.mean(wins),
                            st.stdev(wins) if len(wins) > 1 else 0.0))
    cds = [c for _, c, _ in samples]
    if len(cds) > 1:
        mean, half, sdev, t95 = t_ci(cds)
        print(f"\n[RE10M CI] {regime}: n={len(cds)} realization-samples: Cd {mean:.4f} +- "
              f"{half:.4f} (95% t-CI of the mean, t={t95}; sample sd {sdev:.4f}) | "
              f"ref {ref_cd:.4f} | mean dev {(mean - ref_cd) / ref_cd * 100:+.1f}% | "
              f"device {args.device}", flush=True)
    for tag, cd, sd in samples:
        print(f"  {tag}: {cd:.4f} +- {sd:.4f} ({(cd - ref_cd) / ref_cd * 100:+.1f}%)")
    return samples


if __name__ == "__main__":
    main()

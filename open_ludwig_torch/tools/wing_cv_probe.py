"""Wing forces by stress mapping, momentum exchange and an independent
control-volume momentum balance on the finest level.

    python -m open_ludwig_torch.tools.wing_cv_probe [--case wing_5deg]
        [--res 48] [--steps 12000] [--velocity 0.15] [--device cuda|cpu]
        [--out DIR]

The port's counterpart of `tools/wing_cv_probe.py`: the shipped wing case
at N = `--res`, `--velocity` m/s (laminar: the wall model off), run
`--steps` coarse steps from rest (ramp a quarter of them), then the
finest level's forces by stress mapping, by momentum exchange over the
fluid/solid links, and by `diagnostics.control_volume_force` two cells
inside the level's faces.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from typing import Optional, Sequence

from ..checks import copy_case
from .mem_probe import advance, build_dense_run


def main(argv: Optional[Sequence[str]] = None):
    from ..diagnostics import control_volume_force
    from ..ops.forces import compute_aerodynamics, compute_aerodynamics_mem

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="wing_5deg", choices=("wing_0deg", "wing_5deg"))
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--velocity", type=float, default=0.15)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="validation_runs")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    case = os.path.join(args.out, f"cv_{args.case}")
    shutil.rmtree(case, ignore_errors=True)
    copy_case(args.case, case, {
        "basic.surface_resolution": args.res, "basic.flow.velocity": args.velocity,
        "advanced.high_re.wall_model.enabled": False,
        "basic.simulation.steps": args.steps,
        "basic.simulation.ramp_steps": max(args.steps // 4, 1)})
    c, mesh, params, levels, states, run, fctx, mctx = build_dense_run(
        case, args.device)
    for p in levels:
        print(f"level {p.level_id} interior {tuple(p.interior)} lo {tuple(p.lo)} "
              f"tau {p.tau:.6f}")
    states = advance(run, states, 1, args.steps)

    fr = compute_aerodynamics(states[-1], fctx)
    print(f"[mapping] Cd={fr.Cd:+.4f} Cl={fr.Cl:+.4f} Fx={fr.Fx:+.3e} Fz={fr.Fz:+.3e}")
    fm = None
    if mctx is not None:
        fm = compute_aerodynamics_mem(states[-1], mctx)
        print(f"[mom-ex ] Cd={fm.Cd:+.4f} Cl={fm.Cl:+.4f} Fx={fm.Fx:+.3e} "
              f"Fz={fm.Fz:+.3e} ({mctx.n_links} links)")
    else:
        print("[mom-ex ] no obstacle cells on the finest level")
    rho_phys = c.fluid_density
    F = control_volume_force(states[-1], levels[-1], params, rho_phys, margin=2)
    qA = 0.5 * rho_phys * args.velocity ** 2 * c.reference_area
    print(f"[CV] F = {F} N -> Cd={F[0] / qA:+.4f} Cl={F[2] / qA:+.4f} | velocity "
          f"scale {params.velocity_scale}, dx_fine "
          f"{params.dx_levels[levels[-1].level_id - 1]} | device {args.device}",
          flush=True)
    return fr, fm, F


if __name__ == "__main__":
    main()

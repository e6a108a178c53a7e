"""The JAX runner's windowed sphere Cd on the shipped Re~1M case, on a GPU.

    XLA_PYTHON_CLIENT_PREALLOCATE=false python3 xla_sphere_check.py
        [--steps 24000] [--window-from 8000] [--u-lattice U] [--out DIR]
        [--resume] [--budget-s S]

It runs `open_ludwig_tpu.runner.solve_case` (the JAX package, never the
PyTorch port) on `CASES/sphere_re1m` with the edits that the port's
`open_ludwig_torch/tools/validate_spheres.make_case` makes for its Re~1M
runs: U = 14.8, N = 25, `--steps` coarse steps with a 2000-step ramp, no
flow files, forces every 200 steps, the wall model on and a checkpoint at
every quarter of the run (`--resume` continues from the latest).  One more
edit, `advanced.engine.flat_coarse: off`, keeps level 1 in the 3-D layout,
because off the CPU `open_ludwig_tpu/core/patch.py` stores it flat and the
flat layout has no XLA step.  The runner's batch runner is rebound here to
its XLA path (`make_batch_runner_dense(..., use_pallas=False)`): on a GPU
the default would pick the TPU Pallas kernels.  The package is not edited.

It prints `jax.devices()` on one line first and exits 2 if there is no GPU
device.  Every batch is timed (the runner syncs at each forces row), and
after the second batch the run stops with exit 4 if its projected length
exceeds `--budget-s`.  The last lines are the window statistics over the
force rows after `--window-from`, computed as the port's
`validate_spheres.window_stats` computes them, and one JSON object.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import statistics as st
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
os.environ.setdefault("OPEN_LUDWIG_JAX_CACHE", os.path.join(ROOT, "build", "jax_cache"))

REF_CD, REF_SD = 0.3780, 0.0313  # the reference's late-window Cd at Re 9.87e5


def make_case(case_dir: str, steps: int, resume: bool, u_lattice=None) -> str:
    """CASES/sphere_re1m copied to `case_dir` with the port's validation edits
    and `flat_coarse: off`."""
    import yaml

    src = os.path.join(ROOT, "CASES", "sphere_re1m")
    os.makedirs(case_dir, exist_ok=True)
    with open(os.path.join(src, "config.yaml")) as fh:
        doc = yaml.safe_load(fh)
    shutil.copy(os.path.join(src, doc["basic"]["stl_file"]),
                os.path.join(case_dir, doc["basic"]["stl_file"]))
    overrides = {
        "basic.flow.velocity": 14.8,
        "basic.surface_resolution": 25,
        "basic.simulation.steps": steps,
        "basic.simulation.ramp_steps": 2000,
        "basic.simulation.output_freq": 10 * steps,
        "advanced.high_re.wall_model.enabled": True,
        "advanced.diagnostics.freq": min(200, max(steps // 10, 1)),
        "advanced.checkpoint": {"freq": max(steps // 4, 1), "resume": resume},
        "advanced.engine.flat_coarse": "off",
    }
    if u_lattice is not None:
        overrides["advanced.numerics.u_lattice"] = float(u_lattice)
    for key, value in overrides.items():
        sec = doc
        *parents, leaf = key.split(".")
        for p in parents:
            sec = sec.setdefault(p, {})
        sec[leaf] = value
    with open(os.path.join(case_dir, "config.yaml"), "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    return case_dir


def window_stats(forces_csv: str, last_step: int, window: int):
    """(mean Cd, sd Cd, mean Cl, n) over last_step - window < Step <= last_step."""
    with open(forces_csv) as f:
        rows = list(csv.DictReader(f))
    w = [r for r in rows if last_step - window < int(r["Step"]) <= last_step]
    cds = [float(r["Cd"]) for r in w]
    cls = [float(r["Cl"]) for r in w]
    return (st.mean(cds), st.stdev(cds) if len(cds) > 1 else 0.0,
            st.mean(cls), len(w))


class OverBudget(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=24000)
    ap.add_argument("--window-from", type=int, default=8000)
    ap.add_argument("--u-lattice", type=float, default=None,
                    help="a second realization (the port's re10m_ci r2 uses 0.0295)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "xla_sphere"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--budget-s", type=float, default=3300.0,
                    help="stop after the second batch if the run would take longer")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    print("[XLA-SPHERE] jax", jax.__version__, "devices:", devs, flush=True)
    if not any(d.platform == "gpu" for d in devs):
        print("[XLA-SPHERE] no GPU backend in this jax; not running", flush=True)
        return 2

    import logging

    from open_ludwig_tpu import runner
    from open_ludwig_tpu.config import load_case_config
    from open_ludwig_tpu.solver_dense import make_batch_runner_dense

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    tag = "" if args.u_lattice is None else f"_u{args.u_lattice:g}"
    case = os.path.join(args.out, "val_1M" + tag)
    if not args.resume:
        shutil.rmtree(case, ignore_errors=True)
    make_case(case, args.steps, args.resume, args.u_lattice)
    cfg = load_case_config(case)

    t_start = time.time()
    batches = []  # (coarse steps, seconds) per batch-runner call

    def xla_batch_runner(*a, **k):
        run = make_batch_runner_dense(*a, use_pallas=False, **k)

        def timed(states, t0, n):
            t = time.time()
            out = run(states, t0, n)
            jax.block_until_ready(out)
            batches.append((int(n), time.time() - t))
            print(f"[XLA-SPHERE] batch t0={int(t0)} n={n}: "
                  f"{1e3 * batches[-1][1] / n:.3f} ms per coarse step", flush=True)
            if len(batches) == 2:
                done = int(t0) + n - 1
                left = (cfg.steps - done) * batches[-1][1] / n
                print(f"[XLA-SPHERE] projected: {time.time() - t_start + left:.0f} s "
                      f"for {cfg.steps} steps (budget {args.budget_s:.0f} s)", flush=True)
                if time.time() - t_start + left > args.budget_s:
                    raise OverBudget(f"projected {left:.0f} s more")
            return out

        return timed

    runner.make_batch_runner_dense = xla_batch_runner
    try:
        runner.solve_case(cfg)
    except OverBudget as e:
        print(f"[XLA-SPHERE] over budget: {e}; not run", flush=True)
        return 4
    wall = time.time() - t_start

    forces = os.path.join(cfg.output_path, "forces.csv")
    steps = cfg.steps
    window = steps - int(args.window_from)
    cd, sd, cl, n = window_stats(forces, steps, window)
    se = sd / max(n, 1) ** 0.5
    dev = (cd - REF_CD) / REF_CD * 100
    steady = [s / k for k, s in batches[1:]] or [s / k for k, s in batches]
    print(f"[XLA-SPHERE 1M{tag}] Cd = {cd:.4f} +- {sd:.4f} (Cl {cl:+.3f}, n={n}, "
          f"stderr {se:.4f}, window {steps - window}+ of {steps} steps) | ref "
          f"{REF_CD:.4f} +- {REF_SD:.4f} | dev {dev:+.1f}% | wall {wall:.0f} s", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(forces, os.path.join(out_dir, f"xla_sphere_forces{tag}.csv"))
    print(json.dumps({"cd": cd, "sd": sd, "cl": cl, "n": n, "stderr": se,
                      "dev_pct": dev, "steps": steps, "window_from": steps - window,
                      "u_lattice": cfg.u_lattice, "wall_s": wall,
                      "ms_per_coarse_step": [1e3 * x for x in steady[:3]] +
                      [1e3 * st.median(steady)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

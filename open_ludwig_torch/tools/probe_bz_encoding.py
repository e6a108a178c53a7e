"""Interleaved A/B of the two Bouzidi coefficient encodings on the bench
case's finest-level box: K2 (the signed single array S, production)
against K6 (the retired two arrays A and B).  Both run the same launch, one
cooperative kernel over their link list (csrc/bouzidi_links.cuh), so the
ratio measures the encoding alone.

The port's counterpart of tools/probe_bz_encoding.py.  A and B are exactly
recoverable from S (A = |S|, B = sign(S)(1 - |S|)), so both kernels run on
identical data in one process: one application of each from the same
random bf16 state is checked (decoded f within 2e-3), then each kernel
steps its own copy of that state in interleaved timed windows of --n
applications (CUDA events; the eager time holds the host's launch), and
on the card each is also replayed from a CUDA graph (`checks.graph_ms`:
the device's time).  With --device cpu the wrappers run their plain
versions, timed on the host clock, and there is no graph time.

    python -m open_ludwig_torch.tools.probe_bz_encoding [--res 25] [--levels 3]
        [--n 300] [--reps 6] [--device cuda|cpu]

The default device is cuda, which raises without a GPU.  `main(argv)`
returns the numbers it prints, and the kernels' launch counts
(`cuda_step.LAUNCHES`) as they stood when the last window ended.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..cases import make_case_sphere
from ..checks import graph_ms
from ..config import load_case_config
from ..core.patch import PatchLevel, build_patches
from ..geometry import load_mesh
from ..ops import cuda_step
from ..ops.cuda_step import bouzidi, bouzidi_ab
from ..ops.dense_step import bouzidi_ab_plan, bouzidi_plan_to, build_bouzidi_dense_plan
from ..ops.storage import decode_f
from ..scaling import compute_domain_params

ERR_TOL = 2e-3  # decoded f, one application of K2 against K6 in bf16


def bench_box(case_dir: str, res: int, levels: int) -> Tuple[PatchLevel, Dict]:
    """The bench case's finest level (the sphere at Re~1M with wake, bf16,
    at `res` cells per diameter and `levels` levels, as
    tools/probe_bz_encoding.py:48-58 builds it) and its Bouzidi plan."""
    make_case_sphere(case_dir, "1M", surface_resolution=res, num_levels=levels,
                     steps=400, ramp_steps=200, output_freq=100000,
                     diag_freq=100000, wake_enabled=True, precision="bfloat16")
    cfg = load_case_config(case_dir)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    fine = build_patches(cfg, mesh, params)[-1]
    return fine, build_bouzidi_dense_plan(fine, q_min=cfg.q_min_threshold)


def ref_box_dim(level: PatchLevel) -> Tuple[int, int, int]:
    """The dims of the JAX package's box for the same level: the boundary
    cells' bounds with a one-cell halo, clipped to the padded level, z
    aligned to 128 lanes and y to 8 sublanes
    (open_ludwig_tpu/ops/dense_step.py:1102-1113)."""
    bz = level.bouzidi
    lo = np.array([bz.cell_gx.min(), bz.cell_gy.min(), bz.cell_gz.min()]) - 1
    hi = np.array([bz.cell_gx.max(), bz.cell_gy.max(), bz.cell_gz.max()]) + 2
    X, Y, Z = level.interior
    XS, YS, ZS = X, -(-Y // 8) * 8, -(-Z // 128) * 128  # the JAX package's padded
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, [XS, YS, ZS])
    lo[2], hi[2] = lo[2] // 128 * 128, min(-(-hi[2] // 128) * 128, ZS)
    lo[1], hi[1] = lo[1] // 8 * 8, min(-(-hi[1] // 8) * 8, YS)
    return tuple(int(v) for v in hi - lo)


def _window(fn, states: Dict, key: str, n: int, dev: torch.device) -> float:
    """Milliseconds per application over n applications of fn to
    states[key] (CUDA events on the card, the host clock on the CPU)."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            states[key] = fn(states[key])
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        states[key] = fn(states[key])
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=25)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_bz_encoding: CUDA is not available "
                           "(--device cpu runs the plain versions)")
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        level, plan = bench_box(tmp, args.res, args.levels)
    links = int(np.count_nonzero(plan["S"]))
    print(f"box dim={plan['dim']} lo={plan['lo']} (the port's tight box; the "
          f"JAX package's 8/128-aligned box: dim={ref_box_dim(level)}) "
          f"level {level.interior} links={links}", flush=True)

    shape = (27,) + tuple(level.interior)
    rng = np.random.default_rng(0)
    f0 = torch.as_tensor(rng.standard_normal(shape, np.float32) * 0.01).to(
        device=dev, dtype=torch.bfloat16)
    plan_s = bouzidi_plan_to(plan, dev)
    plan_ab = bouzidi_ab_plan(plan_s, torch.bfloat16)
    apply = {"S": lambda f: bouzidi(f, plan_s), "AB": lambda f: bouzidi_ab(f, plan_ab)}

    # correctness: one application of each from the same state
    one = {m: fn(f0.clone()) for m, fn in apply.items()}
    err = float((decode_f(one["S"]) - decode_f(one["AB"])).abs().max())
    print(f"one-step |S - AB| max = {err:.2e} (decoded f, tol {ERR_TOL:.0e})",
          flush=True)
    if not err < ERR_TOL:
        raise RuntimeError(f"K6 disagrees with K2: {err:.3e} >= {ERR_TOL}")
    del one

    states = {m: f0.clone() for m in apply}
    for m, fn in apply.items():  # warm-up (and the kernels' build)
        states[m] = fn(states[m])
    ms: Dict[str, List[float]] = {m: [] for m in apply}
    for _ in range(args.reps):
        for m, fn in apply.items():
            ms[m].append(_window(fn, states, m, args.n, dev))
    # the launch counts so far: the graphs' captures below add their own
    launches = dict(cuda_step.LAUNCHES)
    graph: Dict[str, Optional[float]] = {m: None for m in apply}
    if dev.type == "cuda":  # interleaved as the windows are
        for m in ("S", "AB", "AB", "S"):
            t = graph_ms(lambda: apply[m](states[m]), args.reps)
            graph[m] = t if graph[m] is None else min(graph[m], t)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, plain versions"
    for m in apply:
        g = "not on the CPU" if graph[m] is None else f"{graph[m]:.5f} ms"
        print(f"bz[{m:2s}] {min(ms[m]):.5f} ms per application ({clock}; reps "
              + ",".join(f"{v:.5f}" for v in ms[m]) + f") | from a CUDA graph {g}",
              flush=True)
    ratio = min(ms["AB"]) / min(ms["S"])
    g = "" if graph["S"] is None else f", from a CUDA graph {graph['AB'] / graph['S']:.3f}"
    print(f"K6 / K2 {ratio:.3f} eager{g} (one launch over the links each: the "
          "encoding alone)", flush=True)
    return {"device": name, "n": args.n, "reps": args.reps,
            "dim": tuple(plan["dim"]), "lo": tuple(plan["lo"]),
            "ref_dim": ref_box_dim(level), "level": tuple(level.interior),
            "links": links, "max_abs_err": err, "ms": ms,
            "ms_min": {m: min(v) for m, v in ms.items()}, "graph_ms": graph,
            "launches": launches}


if __name__ == "__main__":
    main()

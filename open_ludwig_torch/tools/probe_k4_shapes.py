"""K4's launch shapes against each other and against K1, on the card.

K4 (csrc/stream_collide_flat.cu) runs K1's cell body with a launch shape
chosen per storage type and level (`cuda_step.flat_instantiation`).  This
probe builds K4 once more for each fixed shape (threads per block, launch
bounds' blocks per SM; -DOL_K4_THREADS / -DOL_K4_MIN_BLOCKS, every level
at that shape) and times K4 as built, each fixed shape and K1 on one
input, in turns (forward, then backward), eager and replayed from a CUDA
graph (K4 into preallocated outputs), on the bench case's level 1
(64x56x56, the level K4 runs on the main path) and on the 10.8M-cell
single level (232x216x216), bf16 and float32.  Every build must equal K1
bit for bit.  It prints each build's registers and spills.

    python -m open_ludwig_torch.tools.probe_k4_shapes [--reps 20]

Needs a GPU; `main` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence

import torch

from .. import checks
from ..ops import build
from ..ops.cuda_step import flat_choice, stream_collide, stream_collide_flat
from ..solver_dense import build_patch_statics

# (threads per block, minimum blocks per SM in the launch bounds; 1: uncapped)
SHAPES = ((128, 1), (128, 8), (128, 10), (128, 12), (256, 1), (256, 3), (256, 4),
          (256, 6))


def _shape_flags(threads: int, min_blocks: int):
    return (f"-DOL_K4_THREADS={threads}", f"-DOL_K4_MIN_BLOCKS={min_blocks}")


def _registers(built: build.Built) -> Dict[str, str]:
    """"bf16" / "f32" -> "<threads, min blocks>: R registers, S/L B spilled"
    for each instantiation in the build's ptxas log."""
    out = {}
    for fn in checks.ptxas_summary(built.ptxas_log):
        dt = "bf16" if "bfloat16" in fn["function"] else "f32"
        shape = ", ".join(re.findall(r"Li(\d+)E", fn["function"]))
        out.setdefault(dt, []).append(
            f"<{shape}>: {fn['registers']} registers, "
            f"{fn['spill_stores']}/{fn['spill_loads']} B spilled")
    return {k: "; ".join(v) for k, v in out.items()}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_k4_shapes: needs a GPU (K4 is CUDA only)")
    dev = torch.device("cuda", 0)
    names = [f"<{t}, {m}>" for t, m in SHAPES]
    started = [build._start("stream_collide_flat", None, _shape_flags(t, m))
               for t, m in SHAPES]
    libs = {"K4": build.load("stream_collide_flat"), "K1": build.load("stream_collide")}
    for name, (t, m), st in zip(names, SHAPES, started):
        libs[name] = build._finish("stream_collide_flat", st, None, _shape_flags(t, m))
    for name, lib in libs.items():
        if name != "K1":
            print(f"[k4 shapes] build {name}: {_registers(lib)}", flush=True)
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _, _, levels = checks.bench_case(os.path.join(tmp, "bench"))
        kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                  inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
        _, _, _, sweep = checks.bench_case(
            os.path.join(tmp, "sweep"), surface_resolution=25, num_levels=1,
            precision="float32")
        todo = [("L1", levels[0], build_patch_statics(cfg, levels, dev)[0], args.reps),
                ("sweep", sweep[0], build_patch_statics(cfg, sweep, dev)[0],
                 max(args.reps // 4, 2))]
        for label, patch, static, reps in todo:
            static = checks.with_sponge_ramp(static)
            for bf16 in (True, False):
                inp = checks.random_level_inputs(patch, bf16, 21, dev)
                f, vel = inp["f"], inp["vel"]
                bufs = (torch.empty_like(f), torch.empty(f.shape[1:], device=dev),
                        torch.empty_like(vel))

                def run(name):
                    if name == "K1":
                        return stream_collide(f, vel, 0.04, 9, static, patch, **kw)
                    with build.substituted("stream_collide_flat", libs[name]):
                        return stream_collide_flat(f, vel, 0.04, 9, static, patch,
                                                   out=bufs, **kw)

                want = [t.clone() for t in run("K1")]
                equal = {}
                for name in libs:
                    got = run(name)
                    torch.cuda.synchronize(dev)
                    equal[name] = all(torch.equal(a, b) for a, b in zip(got, want))
                order = list(libs) + list(libs)[::-1]
                eager = {n: [] for n in libs}
                graph = {n: [] for n in libs}
                for n in order:
                    eager[n].append(checks.time_cuda(lambda: run(n), reps))
                for n in order:
                    graph[n].append(checks.graph_ms(lambda: run(n), reps))
                bound = checks.bound(*checks.step_work(patch, bf16, kw["wall_model"]),
                                     dev)["bound_ms"]
                chosen = flat_choice(patch, bf16)
                r = {"label": label, "shape": tuple(patch.interior), "bf16": bf16,
                     "bound_ms": bound, "equal": equal, "eager_ms": eager,
                     "graph_ms": graph, "chosen": chosen}
                res.append(r)
                print(f"[k4 shapes] {label} {r['shape']} {'bf16' if bf16 else 'f32 '} | "
                      f"bound {bound:.5f} ms | K4 as built takes <{chosen['threads']}, "
                      f"{chosen['min_blocks']}> | all equal to K1: "
                      f"{all(equal.values())}", flush=True)
                for n in libs:
                    print(f"[k4 shapes]   {n:11s} eager "
                          + ", ".join(f"{t:.5f}" for t in eager[n]) + " | graph "
                          + ", ".join(f"{t:.5f}" for t in graph[n]) + " ms", flush=True)
                if not all(equal.values()):
                    raise RuntimeError(f"a K4 build differs from K1: {equal}")
                del inp, f, vel, bufs, want
                torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()

"""Where K1's time goes inside the cell update, section by section.

K1 (csrc/stream_collide.cu) runs at 60-80% of its byte bound, and `ncu`
does not run on the card machine, so this probe measures the sections of
the cell update from inside the kernel.  It builds K1 twice:
as the solver builds it, timed with CUDA events in a window of about a
second while `nvidia-smi` samples the SM clock and the power draw; and with
-DOL_K1_SECTIONS, where lane 0 of every warp adds the clock64() cycles
between the marks of the update to a device counter per section:

    0 index and pull     1 faces                2 moments and sponge
    3 wall model         4 velocity gradient and WALE
    5 BGK and reconstruction                    6 store

It prints, per shape and storage type, the warp-cycles per cell of each
section (the cycles lane 0 of a warp spent there over the cells the warp
carries: a latency, which the resident warps overlap) and, from the normal build's
time and the sampled clock, the SM cycles per cell (kernel time x SM clock
x SMs / cells: the throughput cost that the 4 issue slots per SM clock
bound).  Loads are asynchronous: their latency lands in the first section
that uses the values (mostly moments), and the compiler may move
independent instructions across a mark, so the split is approximate; the
marked build is slower than the normal one.

    python -m open_ludwig_torch.tools.probe_k1_sections [--csrc DIR]

`--csrc DIR` measures the K1 of another source directory with the same C
interface (an earlier `csrc/` holding the same marks).  Shapes: "L2" is
the bench case's level 2 (46x48x104, six interface faces), "sweep" the
10.8M-cell single level (232x216x216, inlet, outlet and mirrors), both
with the sphere's wall distances, bf16 and float32.  Needs a GPU; `main`
returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import checks
from ..ops import build, cuda_step
from ..solver_dense import build_patch_statics

SECTIONS = ("index+pull", "faces", "moments+sponge", "wall model",
            "vel grad+WALE", "BGK+reconstr.", "store")
MARK_FLAG = "-DOL_K1_SECTIONS"
WINDOW_MS = 1000.0  # the timed window, long enough for ~10 clock samples


class SmiSampler:
    """`nvidia-smi` sampling the SM clock (MHz), the power draw and the power
    limit (W) every `ms` milliseconds between start() and stop()."""

    def __init__(self, ms: int = 100):
        self.ms = ms
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", f"-lms={self.ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> Dict[str, float]:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")[:3]])
            except ValueError:
                continue
        if not rows:
            return {"samples": 0}
        a = np.asarray(rows)
        return {"samples": len(rows), "sm_mhz_mean": float(a[:, 0].mean()),
                "sm_mhz_min": float(a[:, 0].min()), "sm_mhz_max": float(a[:, 0].max()),
                "power_w_mean": float(a[:, 1].mean()), "power_limit_w": float(a[-1, 2])}


def _sections(built: build.Built, reset: bool) -> List[int]:
    fn = built.lib.ol_k1_sections
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 8)()
    rc = fn(out, int(reset))
    if rc != 0:
        raise RuntimeError(f"ol_k1_sections failed: CUDA error {rc}")
    return list(out)


def measure(patch, static, store_bf16: bool, kw: Dict, device,
            csrc: Optional[str]) -> Dict:
    """One shape and storage type: the normal K1's ms per call over a window
    of about WINDOW_MS with the clock sampled beside it, and the marked K1's
    warp-cycles per cell by section."""
    inp = checks.random_level_inputs(patch, store_bf16, 17, device)
    iface = checks.sub_step_planes(inp["iface"], 0)

    def k1():
        return cuda_step.stream_collide(inp["f"], inp["vel"], 0.04, 9, static, patch,
                                        iface=iface, **kw)

    plain_lib = build.load("stream_collide", csrc)
    marked_lib = build.load("stream_collide", csrc, (MARK_FLAG,))
    with build.substituted("stream_collide", plain_lib):
        est = checks.time_cuda(k1, 5)
        reps = max(20, int(WINDOW_MS / max(est, 1e-3)))
        smi = SmiSampler()
        smi.start()
        ms = checks.time_cuda(k1, reps)
        clock = smi.stop()
    with build.substituted("stream_collide", marked_lib):
        k1()
        torch.cuda.synchronize(device)
        _sections(marked_lib, reset=True)
        marked_ms = checks.time_cuda(k1, 5, warmup=0)
        counts = _sections(marked_lib, reset=False)
    cells = counts[7]
    per_cell = [c / max(cells, 1) for c in counts[:7]]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"shape": tuple(patch.interior), "n_cells": patch.n_cells,
           "bf16": store_bf16, "ms": ms, "reps": reps, "marked_ms": marked_ms,
           "clock": clock, "warp_cycles_per_cell": dict(zip(SECTIONS, per_cell)),
           "warp_cycles_per_cell_total": sum(per_cell), "sms": sms}
    if clock.get("samples"):
        out["sm_cycles_per_cell"] = (ms * 1e-3 * clock["sm_mhz_mean"] * 1e6 * sms
                                     / patch.n_cells)
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=None,
                    help="source directory of the K1 to measure (default: csrc/)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_k1_sections: needs a GPU (K1 is CUDA only)")
    dev = torch.device("cuda", 0)
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _, _, levels = checks.bench_case(os.path.join(tmp, "bench"))
        kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
                  inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
        _, _, _, sweep = checks.bench_case(
            os.path.join(tmp, "sweep"), surface_resolution=25, num_levels=1,
            precision="float32")
        todo = [("L2", levels[1], build_patch_statics(cfg, levels, dev)[1]),
                ("sweep", sweep[0], build_patch_statics(cfg, sweep, dev)[0])]
        for label, patch, static in todo:
            for bf16 in (True, False):
                r = measure(patch, static, bf16, kw, dev, args.csrc)
                r["label"] = label
                res.append(r)
                c = r["clock"]
                secs = " | ".join(f"{k} {v:.1f}" for k, v in
                                  r["warp_cycles_per_cell"].items())
                print(f"[k1 sections] {label} {r['shape']} {'bf16' if bf16 else 'f32 '}"
                      f" | K1 {r['ms']:.4f} ms over {r['reps']} calls (marked build "
                      f"{r['marked_ms']:.4f}) | SM clock {c.get('sm_mhz_mean', 0):.0f} "
                      f"MHz ({c.get('sm_mhz_min', 0):.0f}-{c.get('sm_mhz_max', 0):.0f}, "
                      f"{c.get('samples', 0)} samples), power "
                      f"{c.get('power_w_mean', 0):.0f} W of "
                      f"{c.get('power_limit_w', 0):.0f} W | SM cycles per cell "
                      f"{r.get('sm_cycles_per_cell', float('nan')):.1f} | warp-cycles "
                      f"per cell: {secs} | total "
                      f"{r['warp_cycles_per_cell_total']:.1f}", flush=True)
    return res


if __name__ == "__main__":
    main()

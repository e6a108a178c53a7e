"""The bench headline's spread between builds, and each build's device time.

    python -m open_ludwig_torch.tools.headline_spread [--builds 6] [--windows 3]
        [--schedules own,fused]

Builds the bench's headline case `--builds` times in one process
(`bench.build_sphere_runner`) on each of `--schedules` in turns (own,
fused, fused, own, ...: "own" the runner's defaults, unfused; "fused" the
JAX package's K3 pairs on the finest level), each build warmed up and timed as
`open_ludwig_torch.bench.headline` times it (`bench.time_runner`: windows
of 400 coarse steps between CUDA events), then 10 coarse steps profiled
(`tools/profile_slice.measure`), which split the device time between the
port's kernels and the rest; each build is torn down before the next.
Prints one JSON line per build: the median ms a coarse step and the
windows' range, the device ms a coarse step of the port's kernels and of
the rest, and the device-busy share.  Needs a GPU; `main` returns the
lines.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
from typing import Dict, List, Optional, Sequence

import torch

from .. import bench
from . import profile_slice

PROFILED_STEPS = 10


def run_once(windows: int, dev: torch.device, fuse2: bool = False) -> Dict:
    b = bench.build_sphere_runner(device=dev, fuse2=fuse2)
    w = bench.time_runner(b.run, b.states, b.updates_per_coarse,
                          bench.HEADLINE_BATCH, windows, dev)
    prof, _ = profile_slice.measure(b.run, w.states, w.calls[-1][0] + bench.HEADLINE_BATCH,
                                    PROFILED_STEPS, b.updates_per_coarse, dev)
    out = {"engines": b.engines, "warmup_calls": w.warmup,
           "ms": statistics.median(w.ms) / bench.HEADLINE_BATCH,
           "ms_min": min(w.ms) / bench.HEADLINE_BATCH,
           "ms_max": max(w.ms) / bench.HEADLINE_BATCH,
           "port_device_ms": prof["port_device_ms"],
           "other_device_ms": prof["other_device_ms"],
           "busy_share": prof["busy_share"]}
    del b, w, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--builds", type=int, default=6)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--schedules", default="own")
    args = ap.parse_args(argv)
    names = args.schedules.split(",")
    turn = names + names[::-1]  # a, b, b, a, ...
    order = [turn[i % len(turn)] for i in range(args.builds)]
    if not torch.cuda.is_available():
        raise RuntimeError("headline_spread: needs a GPU")
    dev = torch.device("cuda", 0)
    card = bench.card(dev)
    lines = []
    for i, name in enumerate(order):
        line = {"build": i + 1, "schedule": name,
                **run_once(args.windows, dev, fuse2=name == "fused"), "device": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()

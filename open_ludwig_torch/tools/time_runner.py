"""The bench case through the runner on the card: ms per coarse step.

    python3 -m open_ludwig_torch.tools.time_runner [--steps 400] [--diag 100]
        [--label L]

Runs `runner.solve_case` on the bench case (`checks.bench_config`: sphere
Re~1M, N=25, 3 levels + wake, bf16 g-storage; no flow file, no checkpoint
inside the run) in turns graph, eager, eager, graph (graph: the runner's
default, each coarse step a CUDA graph replay; eager: `graphs=False`),
and prints one JSON line: per run the device ms of the batches after the
first from the runner's CUDA events (`SolveResult.windows`), ms per
coarse step, MLUPS-su and MLUPS-ref over them, and the run's wall time
with set-up.  It imports only entry points that every version of the
package since the bench slice has, so the same file run with another
checkout first on PYTHONPATH (`PYTHONPATH=DIR python3
open_ludwig_torch/tools/time_runner.py`) measures that checkout's runner;
a checkout whose `solve_case` takes no `graphs` is run eager only, twice,
and labelled so.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--diag", type=int, default=100)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_runner: needs a GPU")
    import open_ludwig_torch
    from open_ludwig_torch import checks
    from open_ludwig_torch.runner import solve_case

    logging.basicConfig(level=logging.WARNING)
    can_graph = "graphs" in inspect.signature(solve_case).parameters
    order = ["graph", "eager", "eager", "graph"] if can_graph else ["eager"] * 2
    runs = {m: [] for m in dict.fromkeys(order)}
    for mode in order:
        kw = {"graphs": mode == "graph"} if can_graph else {}
        with tempfile.TemporaryDirectory() as tmp:
            cfg = checks.bench_config(os.path.join(tmp, "bench"), steps=args.steps,
                                      diag_freq=args.diag)
            t0 = time.time()
            res = solve_case(cfg, device="cuda", **kw)
            wall = time.time() - t0
        win = res.windows[1:]  # the first batch carries the warm-up
        n = sum(b - a + 1 for a, b, _ in win)
        sec = sum(ms for _, _, ms in win) / 1e3
        runs[mode].append({
            "steps_timed": n, "ms_per_coarse_step": sec / n * 1e3,
            "mlups_su": res.updates_per_coarse * n / sec / 1e6,
            "mlups_ref": res.total_cells * n / sec / 1e6,
            "batch_ms": [ms / (b - a + 1) for a, b, ms in win], "wall_s": wall})
    out = {"label": args.label, "package": open_ludwig_torch.__file__,
           "card": torch.cuda.get_device_name(0), "order": order, **runs}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""The bench slice's coarse steps on the card: time, and every CUDA launch.

    python3 -m open_ludwig_torch.tools.profile_slice [--warmup 20] [--steps 10]

Builds the bench case (`checks.bench_case`: sphere Re~1M, N=25, 3 levels +
wake, bf16 g-storage) and, for each mode of `TURNS` in turn (graph, eager,
eager, graph; graph: each coarse step a CUDA graph replay; eager: every
launch from the host), warms the batch runner up from rest with calls of
`--warmup` coarse steps (`warm_up`: until a call is all graph replays),
then runs the next `--steps` coarse steps in one call (`measure`):

  - ms per coarse step and MLUPS-su from CUDA events, without a profiler,
    and the call's peak allocation;
  - the next steps once more under `torch.profiler`: every CUDA kernel,
    memcpy and memset the device ran per coarse step ("device_ops"), the
    port's own kernel launches per coarse step (`cuda_step.
    executed_launches`: under graphs the captured ones times the replays), the
    device time of the port's kernels and of everything else, and the
    share of the profiled window the device was busy (the union of its
    operations' intervals over the window; the profiler's own host cost
    lowers it).  A trace that kept fewer device operations than the port
    launched is incomplete: its numbers are None ("not measured").

Prints one JSON line.  It imports only entry points that every version of
the package since the bench slice has (a checkout before the graphed
runner is measured eager only), so the same file run with another
checkout first on PYTHONPATH (`PYTHONPATH=DIR python3
open_ludwig_torch/tools/profile_slice.py`) measures that checkout.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# the runners' modes in turns: graph replay, the eager loop, and back
TURNS = ("graph", "eager", "eager", "graph")
MAX_WARMUP = 8  # warm-up calls allowed before a graphed runner must be all replays
# the port's kernels (csrc/*.cu): K1, K3, K4, K5's two, K2's and K6's
PORT_KERNEL = re.compile(r"(stream_collide|fused_pair|stream_collide_flat|edge_copy|"
                         r"inplace|link)_kernel")


def device_ops(events) -> List:
    """The operations the device ran among profiler events."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(ops) -> float:
    """Microseconds covered by the union of the operations' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_calls(fn: Callable[[], object], calls: int) -> Dict:
    """`fn` called `calls` times under torch.profiler (CPU and CUDA
    activity), then synchronised: per call the device operations, and of
    them the port's kernel launches; the device time of the port's
    kernels and of the rest per call; the device-busy share of the window
    (first to last event); and the ten most launched operations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    ops = device_ops(events)
    port = [e for e in ops if PORT_KERNEL.search(e.name)]
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) if events else 0.0
    by_name: Dict[str, int] = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_ops": len(ops) / calls,
        "port_kernels": len(port) / calls,
        "port_device_ms": sum(e.time_range.elapsed_us() for e in port) / calls / 1e3,
        "other_device_ms": sum(e.time_range.elapsed_us() for e in ops
                               if not PORT_KERNEL.search(e.name)) / calls / 1e3,
        "busy_share": busy_us(ops) / window if window > 0 else None,
        "window_ms": window / 1e3,
        "top": [{"name": n[:80], "per_call": c / calls} for n, c in top],
    }


def drop_incomplete(prof: Dict, launches: float) -> Dict:
    """`prof` (a `profile_calls` result) with its device numbers None where
    the trace kept fewer device operations a call than `launches`, the
    port's own launches a call executed: the profiler lost part of the
    trace, and what it kept cannot be read as the call's."""
    if prof["device_ops"] < max(launches, 1):
        prof.update(device_ops=None, port_kernels=None, port_device_ms=None,
                    other_device_ms=None, busy_share=None)
    return prof


def profile_steps(run, states, t0: int, steps: int, updates: int) -> Dict:
    """Coarse steps t0 .. t0 + steps - 1 of batch runner `run`, one call a
    step: timed with CUDA events ("ms", "mlups_su" from `updates` site
    updates a coarse step), then the next `steps` profiled
    (`profile_calls`, with the port's launches a step from
    `cuda_step.LAUNCHES`).  Returns the numbers and the last states."""
    from open_ludwig_torch.ops import cuda_step

    box = {"states": states, "t": t0}

    def step():
        box["states"] = run(box["states"], box["t"], 1)
        box["t"] += 1

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    cuda_step.reset_launches()
    prof = profile_calls(step, steps)
    launches = {k: v / steps for k, v in cuda_step.executed_launches().items() if v}
    prof = drop_incomplete(prof, sum(launches.values()))
    out = {"ms": ms, "mlups_su": updates / ms / 1e3, "port_launches": launches, **prof}
    return out, box["states"]


def measure(run, states, t0: int, steps: int, updates: int, device,
            prof_steps: Optional[int] = None) -> Dict:
    """Coarse steps t0 .. t0 + steps - 1 of batch runner `run` in ONE call,
    timed with CUDA events ("ms" a coarse step, "mlups_su"), with the peak
    allocation of the call above what was live ("peak_bytes") and the
    memory reserved after it; then the next `prof_steps` (default `steps`)
    in one call under torch.profiler (`profile_calls`, per coarse step)
    with the port's launches a step (`cuda_step.executed_launches`:
    captured launches x replays under graphs).  A launch captured inside
    the timed call raises.  Returns the numbers and the last states."""
    from open_ludwig_torch.ops import cuda_step

    captured = getattr(cuda_step, "CAPTURED", {})
    torch.cuda.synchronize(device)
    live = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = sum(captured.values())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    states = run(states, t0, steps)
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / steps
    if sum(captured.values()) != before:
        raise RuntimeError(f"measure: kernel launches captured inside the timed call "
                           f"of steps {t0} .. {t0 + steps - 1}; warm the runner up "
                           "(`warm_up`) with calls of the same length")
    out = {"ms": ms, "mlups_su": updates / ms / 1e3,
           "peak_bytes": torch.cuda.max_memory_allocated(device) - live,
           "live_bytes": live,
           "reserved_bytes": torch.cuda.memory_reserved(device)}
    box = {"states": states}

    n = prof_steps or steps

    def call():
        box["states"] = run(box["states"], t0 + steps, n)

    cuda_step.reset_launches()
    prof = profile_calls(call, 1)
    launches = {k: v / n for k, v in cuda_step.executed_launches().items() if v}
    prof = drop_incomplete(prof, n * sum(launches.values()))
    for key in ("device_ops", "port_kernels", "port_device_ms", "other_device_ms"):
        if prof[key] is not None:
            prof[key] /= n
    prof["top"] = [{**t, "per_call": t["per_call"] / n} for t in prof["top"]]
    return {**out, "port_launches": launches, **prof}, box["states"]


def warm_up(run, states, n: int, t0: int = 1) -> Tuple[object, List[Tuple[int, int]]]:
    """Calls of `n` coarse steps of batch runner `run` from `t0`, t counted
    on, until the runner is ready to be timed with calls of `n` steps: one
    call, or for a graphed runner (`run.graph_set`) as many as it takes
    until a call launches nothing from the host (every step a replay).  A
    graphed runner's (kind, addresses) key runs eagerly at its first use
    and is captured at its second (`graphs.GraphSet`), and a single
    level's odd batch starts on the other buffer at each call, so one call
    does not capture every key the timed calls use.  Returns the states
    and the (t0, n) calls."""
    from open_ludwig_torch.ops import cuda_step

    graphed = getattr(run, "graph_set", None) is not None
    t, calls = t0, []
    for _ in range(MAX_WARMUP):
        issued = sum(cuda_step.LAUNCHES.values())
        states = run(states, t, n)
        calls.append((t, n))
        t += n
        if not graphed or sum(cuda_step.LAUNCHES.values()) == issued:
            return states, calls
    raise RuntimeError(f"warm_up: the runner still launched from the host after "
                       f"{MAX_WARMUP} calls of {n} steps")


def turns(runners: Dict[str, Callable], fresh: Callable[[], object], t0: int,
          steps: int, updates: int, device, order: Sequence[str],
          warmup: int = 4, prof_steps: Optional[int] = None
          ) -> Dict[str, List[Dict]]:
    """`measure` of each runner in `order` (e.g. graph, eager, eager,
    graph), each turn from `fresh()` states after `warm_up`'s calls of
    `warmup` coarse steps from `t0` (a graphed runner's captures happen
    there)."""
    out: Dict[str, List[Dict]] = {k: [] for k in runners}
    for label in order:
        run = runners[label]
        states, calls = warm_up(run, fresh(), warmup, t0)
        res, states = measure(run, states, calls[-1][0] + warmup, steps, updates,
                              device, prof_steps)
        out[label].append(res)
        del states
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_slice: needs a GPU")
    import open_ludwig_torch
    from open_ludwig_torch import checks
    from open_ludwig_torch.solver_dense import (
        build_patch_statics,
        init_patch_state,
        make_batch_runner_dense,
    )

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, _, params, levels = checks.bench_case(tmp)
    statics = build_patch_statics(cfg, levels, dev)
    if "graphs" in inspect.signature(make_batch_runner_dense).parameters:
        order = TURNS
        runners = {m: make_batch_runner_dense(cfg, params, levels, statics,
                                              graphs=m == "graph")
                   for m in dict.fromkeys(order)}
    else:  # a checkout before the graphed runner: eager only
        order = ("eager", "eager")
        runners = {"eager": make_batch_runner_dense(cfg, params, levels, statics)}
    updates = sum(p.n_cells * 2 ** (p.level_id - 1) for p in levels)

    def fresh():
        return [init_patch_state(p, cfg.precision, dev) for p in levels]

    res = turns(runners, fresh, 1, args.steps, updates, dev, order,
                warmup=args.warmup)
    out = {"label": args.label, "package": open_ludwig_torch.__file__,
           "card": torch.cuda.get_device_name(dev), "warmup": args.warmup,
           "steps": args.steps, "order": list(order),
           **{m: [{k: v for k, v in r.items() if k != "top"} for r in rs]
              for m, rs in res.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

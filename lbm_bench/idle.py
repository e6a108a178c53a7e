"""The card's idle time split into host waits and queued gaps.

A reader beside `trace.read`, on the same raw profiler events and the
same idle gaps (the device operations and the window as `read` takes
them, so the split adds up to its idle time):

  - for each idle gap, the device operation that ends it is linked to the
    host call that launched it by the profiler's correlation id: a
    CUDA API call, a host event named "cu..." (`cudaLaunchKernel`,
    `cudaMemcpyAsync`, `cuLaunchKernel`, ...; a graph's kernels carry the
    id of the `cudaGraphLaunch` that replayed them);
  - the part of the gap before that call began is a host wait: the card
    had nothing queued.  It is put down, instant by instant, to the
    innermost host span open then: the program's ("olt.<name>",
    `open_ludwig_torch.spans`), else the harness's ("lbm_bench.<name>"),
    else "host".  A gap that no operation ends (the window's tail) is a
    host wait whole;
  - the rest of the gap is queued: the work was launched and the card
    still idled, kept by the name of the launch call; where the gap
    began with a host wait, the queued rest is the launch's latency (from
    the call to the operation's start on an idle card), else the work was
    queued before the gap began (a graph's node-to-node gaps);
  - a gap ended by an operation with no launch call is unlinked; where
    fewer than 99% of the device operations link to a launch call the
    trace is not read (None), as `read` reads no incomplete trace.
So idle = host waits + queued + unlinked, exactly.

`run.py` does not call it (its record has no field for it): `python3 -m
lbm_bench.idle --workload <cell> --seed <n> --seconds <s>` runs the cell
once with `--trace 1` through the harness's own `run_case`, the split
taken from the same profile that `trace.read` reads, and prints one JSON
line: the cell's end-to-end and per-layer metrics of that traced run
(the traced run's cost against an untraced one), the split, the
program's spans and counters over the window, and its host build by span.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()  # set-up is counted from here, as `run.py` counts it

import argparse  # noqa: E402
import bisect  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import torch  # noqa: E402

HARNESS = "lbm_bench."
PROGRAM = "olt."
LINK_SHARE = 0.99  # device operations that must link to a launch call
LAUNCH = "cu"  # the host's CUDA API calls: runtime ("cuda...") and low-level ("cu...")


@dataclasses.dataclass
class Split:
    """The idle time of a traced window, split (module docstring)."""
    window_ns: int
    idle_ns: int
    host_wait: Dict[str, int]  # host-wait ns by the span open then
    queued: Dict[str, int]  # queued ns by the launch call of the operation ending it
    latency_ns: int  # of the queued ns, those after a host wait: launch to start
    unlinked_ns: int
    coarse_steps: int
    ops: int  # device operations
    linked: Dict[str, int]  # device operations by the name of their launch call

    @property
    def host_wait_ns(self) -> int:
        return sum(self.host_wait.values())

    @property
    def queued_ns(self) -> int:
        return sum(self.queued.values())


class _Spans:
    """Properly nested host spans: the innermost one open at an instant."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        # by start, and of two that start together the outer first
        self.spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.edges = sorted({t for s, e, _ in self.spans for t in (s, e)})

    def at(self, t: int) -> str:
        """The latest-starting span with start <= t < end, "host" if none."""
        for s, e, name in reversed(self.spans[:bisect.bisect_right(self.starts, t)]):
            if e > t:
                return name
        return "host"

    def cover(self, a: int, b: int, into: Dict[str, int]) -> None:
        """Add [a, b) to `into`, piece by piece, under the innermost span."""
        lo, hi = bisect.bisect_right(self.edges, a), bisect.bisect_left(self.edges, b)
        cuts = [a] + self.edges[lo:hi] + [b]
        for x, y in zip(cuts, cuts[1:]):
            if y > x:
                name = self.at(x)
                into[name] = into.get(name, 0) + y - x


def split(prof, coarse_steps: int) -> Optional[Split]:
    """The split of a stopped `torch.profiler.profile`'s window, or None
    where it has no harness span or device operation, or fewer than
    LINK_SHARE of its device operations link to a launch call."""
    cuda = torch.autograd.DeviceType.CUDA
    harness, program, dev, launch = [], [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if not name.startswith(HARNESS):  # as `trace.read` takes them
                dev.append((ev.start_ns(), ev.end_ns(), ev.correlation_id()))
        elif name.startswith(HARNESS):
            harness.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith(PROGRAM):
            program.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith(LAUNCH):
            launch[ev.correlation_id()] = (ev.start_ns(), name)
    if not harness or not dev:
        return None
    linked: Dict[str, int] = {}
    for _, _, corr in dev:
        call = launch.get(corr)
        if call is not None:
            linked[call[1]] = linked.get(call[1], 0) + 1
    if sum(linked.values()) < LINK_SHARE * len(dev):
        return None
    spans = _Spans(harness + program)
    t0 = min(s for s, _, _ in harness)
    t1 = max(max(b for _, b, _ in dev), max(e for _, e, _ in harness))
    intervals = sorted((max(a, t0), b, corr) for a, b, corr in dev if b > t0)
    host_wait: Dict[str, int] = {}
    queued: Dict[str, int] = {}
    unlinked = idle = latency = 0
    edge = t0
    for a, b, corr in intervals + [(t1, t1, None)]:
        if a > edge:
            idle += a - edge
            call = launch.get(corr) if corr is not None else None
            if corr is not None and call is None:
                unlinked += a - edge
            else:
                wait_end = a if call is None else min(max(call[0], edge), a)
                spans.cover(edge, wait_end, host_wait)
                if a > wait_end:
                    queued[call[1]] = queued.get(call[1], 0) + a - wait_end
                    if wait_end > edge:
                        latency += a - wait_end
        edge = max(edge, b)
    return Split(t1 - t0, idle, host_wait, queued, latency, unlinked, coarse_steps,
                 len(dev), linked)


def host_wait_share(s: Split) -> float:
    """Host-wait time over the traced window, in %."""
    return 100.0 * s.host_wait_ns / s.window_ns


def queued_gap_ms_per_step(s: Split) -> Optional[float]:
    """Queued idle milliseconds a traced coarse step."""
    if s.coarse_steps <= 0:
        return None
    return s.queued_ns / 1e6 / s.coarse_steps


def host_wait_by_span(s: Split) -> List[list]:
    """The ten spans with the most host-wait time: [span, seconds]."""
    top = sorted(s.host_wait.items(), key=lambda kv: -kv[1])[:10]
    return [[name, ns / 1e9] for name, ns in top]


def summary(s: Optional[Split]) -> Optional[Dict]:
    if s is None:
        return None
    return {"host_wait_share": host_wait_share(s),
            "queued_gap_ms_per_step": queued_gap_ms_per_step(s),
            "queued_share": 100.0 * s.queued_ns / s.window_ns,
            "queued_s_by_call": {k: v / 1e9 for k, v in s.queued.items()},
            "launch_latency_share": 100.0 * s.latency_ns / s.window_ns,
            "unlinked_share": 100.0 * s.unlinked_ns / s.window_ns,
            "idle_share": 100.0 * s.idle_ns / s.window_ns,
            "window_s": s.window_ns / 1e9, "coarse_steps": s.coarse_steps,
            "device_ops": s.ops, "linked_by_call": s.linked,
            "host_wait_by_span": host_wait_by_span(s)}


def measure(files: Dict, seed: int, seconds: float, device, t_process: float,
            say=None) -> Dict:
    """One traced run of the cell `files` (`harness.cell_files`) through
    `harness.run_case`, with the split of its profile and the program's
    spans and counters over its window: the JSON object `main` prints."""
    from lbm_bench import harness, trace as tr

    try:
        from open_ludwig_torch import spans
    except ImportError:  # a checkout of the program without spans
        spans = None
    got: Dict = {}
    read, window = tr.read, harness.Program.window

    def read_and_split(prof, coarse_steps, *rest):
        got["split"] = split(prof, coarse_steps)
        return read(prof, coarse_steps, *rest)

    def counted_window(self, *a, **k):
        before = spans.snapshot() if spans else None
        out = window(self, *a, **k)
        got["window"] = spans.since(before) if spans else None
        return out

    tr.read, harness.Program.window = read_and_split, counted_window
    try:
        out = harness.run_case(files["case_dir"], files["traffic"], files["limits"],
                               seed, seconds, True, device, t_process, say=say)
    finally:
        tr.read, harness.Program.window = read, window
    rec = out["record"]
    metrics = {}
    for m in files["end_to_end"] + files["per_layer"]:
        v = harness.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = v
    build = None
    if spans:
        build = {k: v for k, v in spans.snapshot()["spans"].items()
                 if k.startswith("build.")}
    return {"seed": seed, "correct": all(c["ok"] for c in out["checks"].values()),
            "metrics": metrics, "split": summary(got.get("split")),
            "window_spans": got.get("window"), "host_build_by_span": build,
            "card": harness.card_line() if rec.device_name != "cpu" else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from lbm_bench import harness
    from lbm_bench.run import CACHES

    os.environ.update(CACHES)
    if not torch.cuda.is_available():
        print("lbm_bench.idle: no CUDA card", file=sys.stderr)
        return 2
    harness.quiet_program_logs()
    line = measure(harness.cell_files(harness.load_spec(), args.workload), args.seed,
                   args.seconds, "cuda:0", T_PROCESS)
    line["workload"] = args.workload
    print(f"[lbm_bench] host build by span: {json.dumps(line['host_build_by_span'])}",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

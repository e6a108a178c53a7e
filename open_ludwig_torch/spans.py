"""Host spans and counters of the port, kept in memory.

`span(name)` times a block on the host: each exit adds one call and its
host nanoseconds to `SPANS[name]` ([calls, ns]).  While a torch.profiler
runs (`torch.autograd._profiler_enabled()`), the block is also a range
"olt.<name>" in the trace, on the profiler's clock, the timeline its
device operations lie on.  The range is a RecordFunction of the function
scope (`torch._C._profiler._RecordFunctionFast`, the range PyTorch's
generated code opens), so it stays on the host's timeline: the profiler
mirrors a user-scope range (`torch.profiler.record_function`) onto the
device's timeline as an annotation, which a reader of the device's
operations would take for one.  Kernels and copies launched inside the
range name it as their host parent (their external id).  With no
profiler running a span costs well under a microsecond, and it never
enters a profiler range (a bare `record_function` costs ~14 us even then).

`count(name, n)` adds to `COUNTS[name]`.  Both tables live as long as the
process; `snapshot()` copies them, `since(before)` gives what was added
after a snapshot, `reset()` empties them and `report(snap)` formats one.
There is no switch: a running profiler turns the ranges on, and the
tables always count.  The spans are for the thread that drives the card.

Spans (a dot names the parent):
  - host preprocessing: `build.patches` (`core.patch.build_patches`) with
    `build.voxelize`, `build.sponge`, `build.wall_distance`,
    `build.bouzidi`; `build.statics` (`solver_dense.build_patch_statics`);
    `build.force_context` (`ops.forces.make_force_context_dense`);
  - the batch runners: `run`, one call, with `run.take` (the caller's
    states onto the runner's buffers), `run.record` (the step record set
    on the stream) and a unit span per coarse step or pair in
    `graphs.GraphSet.run`: `run.eager`, `run.capture` (with the replay
    that follows it) or `run.replay`;
  - events: `forces` (`ops.forces.compute_aerodynamics` and
    `compute_aerodynamics_mem`) with `forces.map` (the launches; on a card
    the stress map's graph inside it, `ops.forces.ForceGraphs`:
    `forces.capture`, its warm-up, capture and first replay, or
    `forces.replay`) and `forces.readback` (the copies to the host);
    `stats` (`diagnostics.compute_flow_stats`) with `stats.reduce` and
    `stats.readback`.
Counters: `sync.forces` and `sync.stats`, each blocking copy to the host
those events make (never captured in a graph, so every one is counted);
`graph.ops` and `graph.steps`, the device operations and the coarse steps
of each graph replay of the batch runners (`graphs.GraphSet`, nodes read
at capture); `forces.capture`, `forces.graph` and `forces.eager`, each
stress map on a card by how it ran: captured (and replayed once),
replayed, or eager past the context's graphs (on the CPU none counts).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch.autograd import _profiler_enabled

PREFIX = "olt."
_clock = time.perf_counter_ns
_Range = torch._C._profiler._RecordFunctionFast
SPANS: Dict[str, List[int]] = {}  # name -> [calls, host ns]
COUNTS: Dict[str, int] = {}


class _Span:
    """The reusable context manager of one span name (`span`); a span is
    never open twice at once (nested in itself, it raises)."""

    __slots__ = ("label", "row", "_t0", "_rng")

    def __init__(self, name: str):
        self.label = PREFIX + name
        self.row = SPANS.setdefault(name, [0, 0])
        self._t0 = 0  # the open block's start ns, 0 when closed
        self._rng = None  # the open block's profiler range

    def __enter__(self):
        if self._t0:
            raise RuntimeError(f"span {self.label} opened inside itself")
        if _profiler_enabled():
            self._rng = _Range(self.label)
            self._rng.__enter__()
        self._t0 = _clock()

    def __exit__(self, exc_type, exc, tb):
        row = self.row
        row[1] += _clock() - self._t0
        row[0] += 1
        self._t0 = 0
        if self._rng is not None:
            rng, self._rng = self._rng, None
            rng.__exit__(exc_type, exc, tb)


_BY_NAME: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span `name` as a context manager (module docstring)."""
    s = _BY_NAME.get(name)
    if s is None:
        s = _BY_NAME[name] = _Span(name)
    return s


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


def snapshot() -> Dict[str, Dict]:
    """Copies of both tables: {"spans": {name: [calls, ns]}, "counts": {...}}."""
    return {"spans": {k: list(v) for k, v in SPANS.items() if v[0]},
            "counts": dict(COUNTS)}


def since(before: Dict[str, Dict]) -> Dict[str, Dict]:
    """What the tables gained after the snapshot `before`, in its form."""
    now = snapshot()
    old_s, old_c = before["spans"], before["counts"]
    spans = {k: [v[0] - old_s.get(k, [0, 0])[0], v[1] - old_s.get(k, [0, 0])[1]]
             for k, v in now["spans"].items()}
    counts = {k: v - old_c.get(k, 0) for k, v in now["counts"].items()}
    return {"spans": {k: v for k, v in spans.items() if v[0]},
            "counts": {k: v for k, v in counts.items() if v}}


def reset() -> None:
    """Zero both tables (a span's row stays its own: it is zeroed in place)."""
    for row in SPANS.values():
        row[0] = row[1] = 0
    COUNTS.clear()


def report(snap: Optional[Dict[str, Dict]] = None) -> str:
    """The spans (calls, host seconds) and counters of `snap` (default:
    the tables as they stand), one per line, by name."""
    snap = snapshot() if snap is None else snap
    lines = [f"[Spans] {name}: {calls} call(s), {ns / 1e9:.6f} s"
             for name, (calls, ns) in sorted(snap["spans"].items())]
    lines += [f"[Counts] {name}: {n}" for name, n in sorted(snap["counts"].items())]
    return "\n".join(lines) if lines else "[Spans] none"

"""The traced part of a window: device operations, host spans, busy time.

The arithmetic is a frozen copy of open_ludwig_torch/tools/profile_slice.py
at commit 8d8a57a (`device_ops`, `busy_us`, `drop_incomplete`), read from
the profiler's raw events instead of its parsed ones (the parse builds a
Python object per event, seconds for the ~10^5 operations a traced call
of a multi-level case runs):

  - the device operations are the trace's events on a CUDA device;
  - busy time is the union of their intervals;
  - a trace that kept fewer of the port's kernels than the program's
    launch counter says ran is incomplete, and nothing is read from it.

The harness marks its host spans (`span`, a `torch.profiler.record_function`
named "lbm_bench.<what>").  An event drains the card before it starts and
reads its values back before it ends, so every operation it launches runs
inside its span: a device operation that starts inside an "event" span is
the event's, every other one the runner's.  Idle time is put in the host
span open when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "lbm_bench."


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span "lbm_bench.<name>" in the trace (nothing when `on` is off)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN + name):
        yield


@dataclasses.dataclass
class Trace:
    """What the traced part of a window ran."""
    window_ns: int  # first host span's start to the last device operation's end
    ops: List[Tuple[str, int, int, str]]  # (name, start, end ns, "event" or "step")
    busy_ns: int  # the union of the device operations' intervals
    coarse_steps: int  # coarse steps the traced calls ran
    gaps: Dict[str, int]  # idle ns by the host span at each gap's start

    def seconds(self, match=None, of: Optional[str] = None) -> float:
        """Device seconds of the operations whose name `match` (a compiled
        regex; None: every name) finds, of "step" or "event" (None: both)."""
        return sum(e - s for n, s, e, what in self.ops
                   if (match is None or match.search(n))
                   and (of is None or what == of)) / 1e9


def busy_ns(intervals: List[Tuple[int, int]]) -> int:
    """The length of the union of the intervals (profile_slice.busy_us)."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


def _innermost(spans: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The name of the innermost host span holding time t ("host" if none):
    the latest-starting span that began by t and has not ended."""
    i = bisect.bisect_right(starts, t)
    best = "host"
    for s, e, name in reversed(spans[:i]):
        if e >= t:
            best = name
            break
    return best


def read(prof, coarse_steps: int, launched: int, kernel_re: re.Pattern) -> Optional[Trace]:
    """The trace of a stopped `torch.profiler.profile`, or None where it is
    incomplete: fewer device operations matching `kernel_re` (the port's
    kernels) than `launched`, the launches the program counted
    (profile_slice.drop_incomplete)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if not name.startswith(SPAN):
            if ev.device_type() == cuda:
                dev.append((name, ev.start_ns(), ev.end_ns()))
        elif ev.device_type() != cuda:
            # (a span is mirrored on the device's timeline as an annotation:
            # not an operation)
            spans.append((ev.start_ns(), ev.end_ns(), name[len(SPAN):]))
    if not spans or not dev:
        return None
    spans.sort()
    starts = [s for s, _, _ in spans]
    ops = [(n, a, b, "event" if _innermost(spans, starts, a) == "event" else "step")
           for n, a, b in dev]
    if sum(1 for n, *_ in ops if kernel_re.search(n)) < launched:
        return None
    t0 = spans[0][0]
    t1 = max(max(b for _, _, b, _ in ops), max(e for _, e, _ in spans))
    intervals = sorted((max(a, t0), b) for _, a, b, _ in ops if b > t0)
    gaps: Dict[str, int] = {}
    edge = t0
    for a, b in intervals + [(t1, t1)]:
        if a > edge:
            label = _innermost(spans, starts, edge)
            gaps[label] = gaps.get(label, 0) + a - edge
        edge = max(edge, b)
    return Trace(t1 - t0, ops, busy_ns(intervals), coarse_steps, gaps)


def breakdown(tr: Trace) -> Dict[str, list]:
    """The ten device operations that took most time, and the idle time by
    the host span at each gap's start, both in seconds."""
    by_name: Dict[str, int] = {}
    for n, s, e, _ in tr.ops:
        by_name[n] = by_name.get(n, 0) + e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}

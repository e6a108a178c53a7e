"""The idle split (`idle.split`) on made-up profiler events with
correlation ids: the host waits and queued gaps add up to `trace.read`'s
idle time, a graph's kernels link to their `cudaGraphLaunch`, host waits
go to the innermost span open at each instant, an under-linked trace
reads nothing; `trace.read` is unchanged by the program's host spans and
the launch calls; the readers, `metrics/sample_syncs.py` among them."""

import json
import os
import re
import types

import pytest
import torch

from lbm_bench import harness, idle, trace as tr

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Ev:
    def __init__(self, name, a, b, dev, corr=0):
        self._n, self._a, self._b, self._d, self._c = name, a, b, dev, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))


HARNESS = [
    _Ev("lbm_bench.call", 0, 100, CPU, 1),
    _Ev("lbm_bench.call", 20, 90, CUDA, 1),  # its mirror
    _Ev("lbm_bench.wait", 100, 120, CPU, 2),
]
DEVICE = [
    _Ev("void fill_kernel", 15, 18, CUDA, 11),  # the step record's
    _Ev("void stream_collide_kernel<float>", 30, 40, CUDA, 12),  # graph 12
    _Ev("void at::native::copy_kernel", 42, 50, CUDA, 12),
    _Ev("void stream_collide_kernel<float>", 70, 80, CUDA, 13),  # graph 13
    _Ev("void at::native::copy_kernel", 81, 90, CUDA, 13),
]
PROGRAM = [  # the program's spans, function scope: on the host alone
    _Ev("olt.run", 2, 98, CPU, 3),
    _Ev("olt.run.take", 2, 10, CPU, 4),
    _Ev("olt.run.record", 10, 14, CPU, 5),
    _Ev("olt.run.replay", 14, 30, CPU, 6),
    _Ev("olt.run.replay", 60, 70, CPU, 7),
    _Ev("aten::fill_", 10, 14, CPU, 11),  # a host op sharing a launch's id
]
LAUNCHES = [
    _Ev("cudaLaunchKernel", 11, 13, CPU, 11),
    _Ev("cudaGraphLaunch", 16, 28, CPU, 12),
    _Ev("cudaGraphLaunch", 62, 68, CPU, 13),
]
KERNEL = re.compile("stream_collide_kernel")


def test_read_ignores_program_spans_and_launch_calls():
    bare = tr.read(_prof(HARNESS + DEVICE), 2, 2, KERNEL)
    full = tr.read(_prof(HARNESS + DEVICE + PROGRAM + LAUNCHES), 2, 2, KERNEL)
    assert bare == full and bare.window_ns == 120 and bare.busy_ns == 40


def test_split_adds_up_to_the_idle_time():
    events = HARNESS + DEVICE + PROGRAM + LAUNCHES
    s = idle.split(_prof(events), 2)
    rec = tr.read(_prof(events), 2, 2, KERNEL)
    assert s.window_ns == rec.window_ns
    assert s.idle_ns == rec.window_ns - rec.busy_ns == 80
    assert s.host_wait_ns + s.queued_ns + s.unlinked_ns == s.idle_ns
    # queued: 11..15 (the fill launched at 11), 18..30 and 40..42 (graph 12
    # launched at 16), 62..70 (graph 13 launched at 62), 80..81
    assert s.queued == {"cudaLaunchKernel": 4, "cudaGraphLaunch": 12 + 2 + 8 + 1}
    assert s.latency_ns == 4 + 8  # 11..15 and 62..70 follow a host wait
    assert s.unlinked_ns == 0
    # host waits: 0..11, 50..62 and the tail 90..120, span by span
    assert s.host_wait == {"lbm_bench.call": 2 + 2, "olt.run.take": 8,
                           "olt.run.record": 1, "olt.run": 10 + 8,
                           "olt.run.replay": 2, "lbm_bench.wait": 20}


def test_graph_kernels_link_to_their_graph_launch():
    s = idle.split(_prof(HARNESS + DEVICE + PROGRAM + LAUNCHES), 2)
    assert s.linked == {"cudaLaunchKernel": 1, "cudaGraphLaunch": 4} and s.ops == 5


def test_under_linked_trace_reads_nothing():
    assert idle.split(_prof(HARNESS + DEVICE + PROGRAM + LAUNCHES[:2]), 2) is None
    assert idle.split(_prof(DEVICE + LAUNCHES), 2) is None  # no harness span


def test_an_unlinked_gap_is_counted_apart(monkeypatch):
    monkeypatch.setattr(idle, "LINK_SHARE", 0.5)
    s = idle.split(_prof(HARNESS + DEVICE + PROGRAM + LAUNCHES[:2]), 2)
    assert s.unlinked_ns == 20 + 1  # 50..70 and 80..81, ended by graph 13's kernels
    assert s.host_wait_ns + s.queued_ns + s.unlinked_ns == s.idle_ns == 80


def test_split_readers():
    s = idle.split(_prof(HARNESS + DEVICE + PROGRAM + LAUNCHES), 2)
    assert idle.host_wait_share(s) == 100 * 53 / 120
    assert idle.queued_gap_ms_per_step(s) == 27 / 1e6 / 2
    top = idle.host_wait_by_span(s)
    assert top[0] == ["lbm_bench.wait", 20 / 1e9] and len(top) == 6
    out = idle.summary(s)
    assert out["idle_share"] == pytest.approx(out["host_wait_share"] + out["queued_share"])
    assert idle.summary(None) is None


def test_sample_syncs_reads_the_program_counters(monkeypatch):
    from open_ludwig_torch import spans
    read = harness.reader("sample_syncs")
    monkeypatch.setattr(spans, "SPANS", {"forces": [4, 1000]})
    monkeypatch.setattr(spans, "COUNTS", {"sync.forces": 20, "sync.stats": 2})
    assert read(None) == 5.0
    monkeypatch.setattr(spans, "SPANS", {})
    assert read(None) is None


def test_measure_on_a_tiny_case(tiny_case, tiny_traffic):
    """The traced run through `run_case` on the CPU: its metrics, the
    program's spans and counters over the window and its host build by
    span (the CPU trace has no device operation, so no split)."""
    spec = harness.load_spec()
    with open(os.path.join(harness.HERE, "configs", "sphere_re10m", "limits.json")) as fh:
        limits = json.load(fh)
    files = {"case_dir": tiny_case, "traffic": tiny_traffic, "limits": limits,
             "end_to_end": spec["end_to_end"], "per_layer": spec["per_layer"]}
    read, window = tr.read, harness.Program.window
    line = idle.measure(files, 2 ** 31 + 11, 0.0, "cpu", 0.0, say=lambda m: None)
    assert (tr.read, harness.Program.window) == (read, window)  # restored
    assert line["correct"] and line["split"] is None and line["card"] == "cpu"
    assert line["metrics"]["sample_syncs"] == 5.0 and "mlups_su" in line["metrics"]
    counts = line["window_spans"]["counts"]
    calls = line["window_spans"]["spans"]["forces"][0]
    assert calls >= 1 and counts["sync.forces"] == 5 * calls
    assert {"build.patches", "build.statics", "build.force_context",
            "build.voxelize"} <= set(line["host_build_by_span"])

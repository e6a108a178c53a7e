"""The trace's arithmetic on made-up profiler events: busy time, the event
operations told from the steps', idle time by host span, the readers."""

import re
import types

import torch

from lbm_bench import harness, trace as tr

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Ev:
    def __init__(self, name, a, b, dev):
        self._n, self._a, self._b, self._d = name, a, b, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))


EVENTS = [
    _Ev("lbm_bench.call", 0, 100, CPU),
    _Ev("lbm_bench.call", 0, 100, CUDA),  # the span's annotation on the device
    _Ev("void stream_collide_kernel<float>", 10, 60, CUDA),
    _Ev("void stream_collide_kernel<float>", 50, 90, CUDA),  # overlaps: busy 10..90
    _Ev("void at::native::copy_kernel", 95, 105, CUDA),
    _Ev("lbm_bench.drain", 100, 110, CPU),
    _Ev("lbm_bench.event", 120, 200, CPU),
    _Ev("void at::native::reduce_kernel", 150, 170, CUDA),
]


def test_read_busy_gaps_and_events():
    rec = tr.read(_prof(EVENTS), 4, 2, re.compile("stream_collide_kernel"))
    assert rec.window_ns == 200 and rec.busy_ns == 80 + 10 + 20
    assert [what for *_, what in rec.ops] == ["step", "step", "step", "event"]
    # idle: 0..10 in call, 90..95 in call, 105..150 from drain's end (event
    # at 120), 170..200 in event
    assert rec.gaps == {"call": 15, "drain": 45, "event": 30}
    assert rec.seconds(re.compile("reduce"), "event") == 20 / 1e9
    out = tr.breakdown(rec)
    assert out["device_ops"][0] == ["void stream_collide_kernel<float>", 90 / 1e9]
    assert out["idle_gaps"][0] == ["drain", 45 / 1e9]


def test_incomplete_trace_reads_nothing():
    assert tr.read(_prof(EVENTS), 4, 3, re.compile("stream_collide_kernel")) is None
    assert tr.read(_prof(EVENTS[:2]), 4, 0, re.compile("x")) is None


def test_trace_readers():
    rec = harness.RunRecord(
        device_name="NVIDIA H100 80GB HBM3", setup_s=1.0, host_build_s=0.5, window_s=2.0,
        coarse_steps=10, updates_per_coarse=1000, peak_reserved_bytes=2e9,
        sample_ms=[float(i) for i in range(1, 101)], event_ms=[1.0, 3.0],
        levels=[{"interior": (10, 10, 10), "face_bc": (0, 1, 2, 2, 3, 3), "sub_steps": 1}],
        store_bf16=False, wall_model=True, kernels=harness.kernel_patterns(),
        trace=tr.read(_prof(EVENTS), 4, 2, re.compile("stream_collide_kernel")))
    read = {m: harness.reader(m)(rec) for m in (
        "idle_share", "glue_ms_per_step", "stream_collide_roofline", "step_mfu",
        "event_ms", "mlups_su", "sample_p95_ms", "peak_reserved_gb", "setup_s",
        "host_build_s")}
    assert read["idle_share"] == 100 * (1 - 110 / 200)
    assert read["glue_ms_per_step"] == 10 / 1e6 / 4  # the copy, not the event's reduce
    least = 4 * 1000 * 253 / 3.35e12
    assert abs(read["stream_collide_roofline"] - 100 * least / 90e-9) < 1e-6
    assert abs(read["step_mfu"] - 100 * least / 200e-9) < 1e-6
    assert read["event_ms"] == 2.0 and read["mlups_su"] == 10 * 1000 / 2.0 / 1e6
    assert 95 <= read["sample_p95_ms"] <= 96 and read["peak_reserved_gb"] == 2.0

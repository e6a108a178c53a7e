"""The port's host spans and counters (`open_ludwig_torch/spans.py`) on a
tiny two-level sphere, on the CPU:

- under a CPU torch.profiler the spans are "olt.<name>" ranges that nest
  as the module's docstring lists them (the host build, the graphed
  runner's call and its units, the forces and the flow statistics), and
  none is a user annotation (the kind the profiler mirrors onto a
  device's timeline);
- with the profiler off, no profiler range is ever entered (the range
  constructors patched to raise), and the tables still count;
- `sync.forces` counts 5 blocking copies a force evaluation, `sync.stats`
  1 a flow statistics, `planes.plain` each child build of the ghost planes
  (plain torch on the CPU);
- the states and forces are bit-equal with the profiler on and off.
"""

import numpy as np
import pytest
import torch

from open_ludwig_torch import checks, diagnostics, spans
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.ops import forces
from open_ludwig_torch.scaling import compute_domain_params

# (parent, children) as the spans module's docstring lists them
TREE = {
    "build.patches": ("build.voxelize", "build.sponge", "build.wall_distance",
                      "build.bouzidi"),
    "run": ("run.take", "run.record", "run.eager"),
    "forces": ("forces.map", "forces.readback"),
    "stats": ("stats.reduce", "stats.readback"),
}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spans"))
    make_case_sphere(d, "1M", surface_resolution=6, num_levels=2, steps=4,
                     ramp_steps=2, output_freq=100, diag_freq=100, wake_enabled=False)
    checks.edit_config(d, {"advanced.high_re.min_coarse_blocks": 1})
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params


def _build(case):
    cfg, mesh, params = case
    levels = build_patches(cfg, mesh, params)
    statics = sd.build_patch_statics(cfg, levels, "cpu")
    ctx = forces.make_force_context_dense(mesh, levels[-1], params,
                                          extrapolate=cfg.force_extrapolate)
    return cfg, params, levels, statics, ctx


def _drive(cfg, params, levels, statics, ctx):
    """Two graphed-runner calls from rest, then one force evaluation and
    one flow statistics: (states, forces, statistics)."""
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels]
    states = run(states, 1, 2)
    states = run(states, 3, 1)
    res = forces.compute_aerodynamics(states[-1], ctx)
    stats = diagnostics.compute_flow_stats(states[0], statics[0]["obstacle"])
    return states, res, stats


def test_span_tree_under_the_profiler(case):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        built = _build(case)
        _drive(*built)
    ranges = [(ev.name()[len(spans.PREFIX):], ev.start_ns(), ev.end_ns(),
               ev.is_user_annotation())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(spans.PREFIX)]
    names = {n for n, *_ in ranges}
    assert {"build.statics", "build.force_context"} <= names
    assert not any(user for *_, user in ranges)
    for parent, children in TREE.items():
        outer = [(a, b) for n, a, b, _ in ranges if n == parent]
        assert outer, parent
        for child in children:
            inner = [(a, b) for n, a, b, _ in ranges if n == child]
            assert inner, child
            for a, b in inner:
                assert any(pa <= a and b <= pb for pa, pb in outer), (parent, child)
    # one unit span a coarse step, inside the calls
    assert sum(1 for n, *_ in ranges if n == "run.eager") == 3
    assert sum(1 for n, *_ in ranges if n == "run") == 2


def test_profiler_off_enters_no_range_and_still_counts(case, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a profiler range entered with the profiler off")

    monkeypatch.setattr(spans, "_Range", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    before = spans.snapshot()
    _drive(*_build(case))
    got = spans.since(before)
    for parent, children in TREE.items():
        for name in (parent,) + children:
            calls, ns = got["spans"][name]
            assert calls >= 1 and ns > 0, name
    assert got["spans"]["run"][0] == 2 and got["spans"]["run.eager"][0] == 3
    # and one child build of the ghost planes a coarse step, plain on the CPU
    assert got["counts"] == {"sync.forces": 5, "sync.stats": 1, "planes.plain": 3}
    assert "[Spans] run: 2 call(s)" in spans.report(got)


def test_sync_counts_per_event(case):
    cfg, params, levels, statics, ctx = _build(case)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels]
    before = spans.snapshot()
    for _ in range(3):
        forces.compute_aerodynamics(states[-1], ctx)
    diagnostics.compute_flow_stats(states[0], statics[0]["obstacle"])
    got = spans.since(before)
    assert got["counts"] == {"sync.forces": 15, "sync.stats": 1}
    assert got["spans"]["forces"][0] == 3 and got["spans"]["forces.readback"][0] == 3
    assert got["spans"]["stats"][0] == 1


def test_bit_equal_with_the_profiler_on_and_off(case):
    built = _build(case)
    off = _drive(*built)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _drive(*built)
    for a, b in zip(off[0], on[0]):
        for k in ("f", "rho", "vel"):
            assert torch.equal(a[k], b[k]), k
    for name in ("Fx", "Fy", "Fz", "Mx", "My", "Mz", "Cd", "Cl"):
        assert getattr(off[1], name) == getattr(on[1], name), name
    assert np.array_equal(off[1].pressure_map, on[1].pressure_map)
    assert off[2] == on[2]


def test_snapshot_since_and_reset(monkeypatch):
    monkeypatch.setattr(spans, "SPANS", {})
    monkeypatch.setattr(spans, "COUNTS", {})
    monkeypatch.setattr(spans, "_BY_NAME", {})
    with spans.span("a"):
        with pytest.raises(RuntimeError, match="inside itself"):
            with spans.span("a"):
                pass
    with spans.span("a"):
        pass
    spans.count("c", 2)
    snap = spans.snapshot()
    assert snap["spans"]["a"][0] == 2 and snap["counts"] == {"c": 2}
    with spans.span("a"):
        pass
    assert spans.since(snap)["spans"]["a"][0] == 1
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counts": {}}
    with spans.span("a"):
        pass
    assert spans.snapshot()["spans"]["a"][0] == 1

"""The card's kernel rule (`ops/engine.card_engines`) and the device-memory
estimate it reads (`memory`), on the CPU.

- A level with interface faces runs K1; an interface-free one K4, or K1
  where it is the finest; an interface-free level moves to K5 where the
  case's estimate with it stepping A -> B exceeds the capacity, and the
  reason says so, also where K5 does not make the case fit.  Synthetic
  levels: the rule reads only the levels' shapes and faces.
- On an x mesh the capacity is per card: the slabs on one card add up, so
  a virtual mesh (every slab on one device) needs the whole level, two
  cards half each.
- `build_patch_statics` / `shard_statics` record the card's choice and its
  reason; `kernel_log_lines` gives the reason, and says why the finest
  level takes no K3 by default.
- The estimate: every level's second buffers add up (the graphed runner
  holds them all), the report's total is the rule's, and the graphed
  runner's first coarse step releases the caller's states as it replaces
  them, so that its peak is the estimate's.
- `tools/probe_peak_memory.peak_live` on a synthetic allocator trace.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from open_ludwig_torch import memory
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import (BC_INLET, BC_INTERFACE, BC_MIRROR_Y,
                                          BC_MIRROR_Z, BC_OUTLET, PatchLevel,
                                          build_patches)
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.ops import engine
from open_ludwig_torch.parallel import patch_shard as ps
from open_ludwig_torch.scaling import compute_domain_params

torch.set_num_threads(2)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
ROW64 = (432, 384, 384)  # the 63.7M-cell sweep row's level (res 45, snapped)


def case_bytes(patches, engines, precision, devices=None):
    """`memory.case_bytes` with no plans, over `devices`' slabs if given."""
    bounds = ([ps.slab_bounds(p.interior[0], len(devices)) for p in patches]
              if devices else None)
    return memory.case_bytes(patches, engines, precision, None, devices, bounds)


def card_engines(patches, precision, capacity, devices=None):
    """The card's rule on `patches` with no plans, reading `case_bytes`'s
    most loaded card."""
    return engine.card_engines(
        patches, capacity,
        lambda engs: max(case_bytes(patches, engs, precision, devices).values()))


def _level(shape, face_bc=DOMAIN, level_id=1, fields=False):
    """A level of `shape`; its static fields only where `fields` (the rule
    does not read them)."""
    sh = tuple(shape) if fields else (1, 1, 1)
    return PatchLevel(level_id=level_id, dx=1.0, tau=0.51, lo=(0, 0, 0),
                      interior=tuple(shape), face_bc=tuple(face_bc),
                      obstacle=np.zeros(sh, bool), sponge=np.zeros(sh, np.float32),
                      wall_dist=np.full(sh, 10.0, np.float32))


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_card_rule_runs_k1_where_the_case_fits(precision):
    row = _level(ROW64)
    bf16 = precision == "bfloat16"
    need = case_bytes([row], ["k1"], precision)["device"]
    k5 = case_bytes([row], ["inplace"], precision)["device"]
    fb = 2 if bf16 else 4
    # A -> B holds a second f beside the state; K5 only rho, vel and edges
    assert need - k5 >= row.n_cells * (27 * fb - 27 * fb / 4)
    for cap in (80 * 10**9, need, None):
        (eng, why), = card_engines([row], precision, cap)
        assert eng == "k1", (cap, why)
        assert why.startswith("interface-free finest level: K1 (") and "; A->B " in why
    assert "no memory limit" in card_engines([row], precision, None)[0][1]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_card_rule_keeps_k5_below_the_estimate(precision):
    row = _level(ROW64)
    need = case_bytes([row], ["k1"], precision)["device"]
    (eng, why), = card_engines([row], precision, need - 1)
    assert eng == "inplace"
    assert why.startswith("interface-free: K5 in place")
    assert f"{need / 1e9:.1f} GB exceeds" in why and "still exceeds" not in why


def test_card_rule_keeps_flat_and_k1_levels():
    """Level 1 interface-free below a child (K4), level 2 with interface
    faces (K1); at a capacity nothing fits level 1 moves to K5, saying the
    case still does not fit, and level 2 stays K1; a large level 1 takes
    K4 only if the whole case fits."""
    l1 = _level((64, 56, 56))
    l2 = _level((46, 48, 104), (BC_INTERFACE,) * 6, level_id=2)
    got = card_engines([l1, l2], "bfloat16", None)
    assert [e for e, _ in got] == ["flat", "k1"]
    assert "neither finest nor Bouzidi: K4" in got[0][1]
    assert "no memory limit" in got[0][1]
    assert got[1][1] == "interface faces: K1 reads the ghost planes"
    got = card_engines([l1, l2], "bfloat16", 1)
    assert [e for e, _ in got] == ["inplace", "k1"]
    assert "K5 in place" in got[0][1] and "still exceeds it" in got[0][1]
    assert got[1][1] == "interface faces: K1 reads the ghost planes"
    big = _level(ROW64)
    child = _level((40, 40, 40), (BC_INTERFACE,) * 6, level_id=2)
    both = case_bytes([big, child], ["flat", "k1"], "bfloat16")["device"]
    assert [e for e, _ in card_engines([big, child], "bfloat16", both)] == ["flat", "k1"]
    assert [e for e, _ in card_engines([big, child], "bfloat16", both - 1)] == \
        ["inplace", "k1"]


def test_card_rule_adds_up_the_slabs_of_a_card():
    """A virtual mesh of 2 slabs on one device needs both slabs' bytes there;
    a mesh of 2 cards each holds one slab (and its two edge planes)."""
    row = _level(ROW64)
    one = case_bytes([row], ["k1"], "bfloat16")["device"]
    virtual = [torch.device("cpu")] * 2
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    v = case_bytes([row], ["k1"], "bfloat16", virtual)
    c = case_bytes([row], ["k1"], "bfloat16", two)
    assert list(v) == ["cpu"] and sorted(c) == ["cuda:0", "cuda:1"]
    edges = 2 * 384 * 384 * (27 * 2 + 12)  # a slab's two edge planes
    assert v["cpu"] >= one + 2 * edges - 20 * memory.ALLOC_ROUND
    assert max(c.values()) < 0.6 * v["cpu"]
    cap = (max(c.values()) + v["cpu"]) // 2
    assert card_engines([row], "bfloat16", cap, devices=virtual)[0][0] == "inplace"
    assert card_engines([row], "bfloat16", cap, devices=two)[0][0] == "k1"


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """A small sphere case's config (bf16) and one synthetic level of 8 x
    384 x 384 cells with its fields."""
    d = str(tmp_path_factory.mktemp("wide"))
    make_case_sphere(d, "1M", surface_resolution=6, num_levels=1, steps=2,
                     ramp_steps=1, output_freq=100, diag_freq=100)
    cfg = dataclasses.replace(load_case_config(d), precision="bfloat16")
    return cfg, _level((8, 384, 384), fields=True)


def test_statics_record_the_card_choice(wide):
    cfg, lvl = wide
    need = case_bytes([lvl], ["k1"], cfg.precision)["device"]
    for cap, want in ((None, "k1"), (10 * need, "k1"), (need // 2, "inplace")):
        st, = sd.build_patch_statics(cfg, [lvl], "cpu", capacity=cap)
        assert st["engine"] == want, cap
        assert ("K5 in place" if want == "inplace" else "finest level: K1") \
            in st["engine_why"]
    # on two CPU slabs (a virtual mesh): the card's rule for the slabs' sum
    xm = ps.make_x_mesh(2, "cpu")
    per = case_bytes([lvl], ["k1"], cfg.precision, xm.devices)["cpu"]
    for cap, want in ((per, "k1"), (per - 1, "inplace")):
        st, = sd.build_patch_statics(cfg, [lvl], x_mesh=xm, capacity=cap)
        assert st["engine"] == want, cap
    report = sd.hbm_report_patches([lvl], [st], cfg.precision, "cpu", x_mesh=xm)
    assert "cpu: " in report and "(2 slab(s))" in report


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere2_rule"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=4,
                     ramp_steps=2, output_freq=100, diag_freq=100,
                     wake_enabled=False)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, params, build_patches(cfg, mesh, params)


def test_kernel_log_names_both_rules_and_why_no_k3(sphere2):
    cfg, _, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    lines = sd.kernel_log_lines(levels, statics, cfg.precision, "cpu")
    assert not any("the JAX package runs" in ln for ln in lines)
    assert "K4 stream_collide_flat" in lines[0]
    assert "neither finest nor Bouzidi: K4" in lines[0]
    assert "interface faces: K1 reads the ghost planes" in lines[1]
    assert "K3 no: unfused by default on this card" in lines[-1]
    assert "0.063-0.066 ns a cell" in lines[-1] and "fuse2=True" in lines[-1]
    fused = sd.kernel_log_lines(levels, statics, cfg.precision, "cpu", fuse2=True)
    assert "K3 fused_pair" in fused[-1]


def test_second_buffers_add_up_over_the_levels(sphere2):
    """The report's total is the rule's estimate (`case_bytes` with the
    plans' bytes), and it counts every level's second buffers."""
    cfg, _, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    engs = [st["engine"] for st in statics]
    fb = 2 if cfg.precision == "bfloat16" else 4
    extra = memory.plans_extra([st["bouzidi"] for st in statics],
                               [st["iface_mm"] for st in statics], fb)
    total = sd.hbm_total_patches(levels, statics, cfg.precision)
    assert total == memory.case_bytes(levels, engs, cfg.precision, extra)["device"]
    parts = [memory.level_bytes(p.n_cells, fb, e) for p, e in zip(levels, engs)]
    assert total >= sum(r + s for r, s in parts) + sum(extra)
    assert all(s >= p.n_cells * (27 * fb + 16) for p, (_, s) in zip(levels, parts))
    # the ghost planes' working set is the child's: at least its largest
    # group's plane values at both sub-step weights (`memory.PLANE_WORK`)
    groups = statics[1]["iface_mm"]["groups"]
    assert extra[0] < extra[1]
    assert extra[1] >= max(4 * len(g["faces"]) * 2 * memory.PLANE_WORK[0] * g["A"] * g["B"]
                           for g in groups)


def test_plane_working_set_counts_the_largest_group(sphere2):
    """The planes' bytes: the plan, every group's planes (27 values of the
    storage type a plane cell, both weights) and one working set, the
    largest group's, since each group's temporaries replace the last's."""
    cfg, _, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    mm = statics[1]["iface_mm"]
    groups = mm["groups"]
    assert len(groups) > 1
    cells = [len(g["faces"]) * 2 * g["A"] * g["B"] for g in groups]
    for fb in (2, 4):
        _, _, planes = memory.plan_bytes(None, mm, None, fb)
        work = planes - memory._nbytes(mm) - 27 * fb * sum(cells)
        big = max(range(len(groups)), key=lambda i: cells[i])
        assert work == memory._plane_work(groups[big])
        assert work < sum(memory._plane_work(g) for g in groups)


def test_graphed_first_step_releases_the_callers_states(sphere2, monkeypatch):
    """The graphed runner's step takes the caller's list over: level 1's
    first state is freed once its first sub-step has replaced it, before
    level 2 steps.  Before, the caller's list kept every level's first
    state through the first coarse step, a third copy at its peak."""
    cfg, params, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels]
    first = weakref.ref(states[0]["f"])
    alive = []
    k1 = sd.stream_collide

    def watch(f, *args, **kw):
        if f.shape[1:] == tuple(levels[-1].interior):
            alive.append(first() is not None)
        return k1(f, *args, **kw)

    monkeypatch.setattr(sd, "stream_collide", watch)
    gc.disable()  # reference counting alone must free it
    try:
        out = run(states, 1, 2)
    finally:
        gc.enable()
    assert out is states and len(alive) == 4 and not any(alive), alive


def test_peak_live_groups_an_allocator_trace():
    from open_ludwig_torch.tools import probe_peak_memory as pm

    fr = [{"filename": "/x/site-packages/torch/a.py", "line": 1, "name": "g"},
          {"filename": "/x/open_ludwig_torch/solver_dense.py", "line": 9, "name": "h"}]
    trace = [{"action": "free_requested", "addr": 99, "size": 7},  # before the trace
             {"action": "alloc", "addr": 1, "size": 10, "frames": fr},
             {"action": "alloc", "addr": 2, "size": 5, "frames": fr},
             {"action": "free_requested", "addr": 1, "size": 10},
             {"action": "free_completed", "addr": 1, "size": 10},
             {"action": "alloc", "addr": 3, "size": 6, "frames": []},
             {"action": "alloc", "addr": 4, "size": 1, "frames": fr[:1]}]
    peak, groups = pm.peak_live(trace)
    assert peak == 15
    assert groups == [{"site": "open_ludwig_torch/solver_dense.py:9 h", "bytes": 15,
                       "blocks": 2}]

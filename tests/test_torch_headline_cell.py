"""The benchmark's headline configuration (`lbm_bench/configs/
sphere_re1m_bench`: the sphere at Re~1M, 3 levels with the wake box, wall
model, bf16 g = f - w storage) cut to N = 8: the program's batch runner
against the harness's plain reference (`lbm_bench.reference.model.
Reference`) over 2 coarse steps from a seeded warm start, within the
configuration's limits, and the float8-rounded reference
(`lbm_bench.control_bf16.Float8Reference`) outside them; the counter of
device operations a replayed coarse step runs (`graphs.GraphSet`,
`spans.COUNTS` "graph.ops" / "graph.steps") on a fake captured schedule,
and on the card against the profiler's count."""

import json
import os
import sys

import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lbm_bench import compare, control_bf16, harness  # noqa: E402
from open_ludwig_torch import graphs, spans  # noqa: E402

CONFIG = os.path.join(harness.HERE, "configs", "sphere_re1m_bench")
TRAFFIC = {"call_steps": 2, "trace_calls": 1, "check_steps": 2, "perturb_rho": 0.001,
           "perturb_u": 0.05}
SEED = 2 ** 31 + 11


def cut_case(path, res: int = 8) -> str:
    """The configuration's case at surface resolution `res`, 3 levels kept
    by `min_coarse_blocks: 1`."""
    with open(os.path.join(CONFIG, "config.yaml")) as fh:
        doc = yaml.safe_load(fh)
    doc["basic"]["stl_file"] = os.path.join(harness.HERE, "geometry", "sphere.stl")
    doc["basic"]["surface_resolution"] = res
    doc["advanced"]["high_re"]["min_coarse_blocks"] = 1
    with open(os.path.join(str(path), "config.yaml"), "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    return str(path)


def limits():
    with open(os.path.join(CONFIG, "limits.json")) as fh:
        return json.load(fh)["limits"]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        case = cut_case(tmp_path_factory.mktemp("re1m_cut"))
        rows = list(control_bf16.readings(case, TRAFFIC, [SEED], 1, 0.0, "cpu",
                                          say=lambda m: None))
    finally:
        torch.set_num_threads(n)
    return case, rows[0]


def test_the_cut_case_keeps_the_headline_s_features(readings):
    from open_ludwig_torch.config import load_case_config
    from open_ludwig_torch.core.patch import build_patches
    from open_ludwig_torch.geometry import load_mesh
    from open_ludwig_torch.scaling import compute_domain_params
    cfg = load_case_config(readings[0])
    assert cfg.precision == "bfloat16" and cfg.wall_model_enabled and cfg.wake_enabled
    assert cfg.temporal_interpolation
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    levels = build_patches(cfg, mesh, compute_domain_params(cfg, mesh.min_bounds,
                                                            mesh.max_bounds))
    assert [p.bouzidi is not None for p in levels] == [False, False, True]


def test_the_runner_holds_the_configuration_s_limits(readings):
    prog = readings[1]["program"]
    assert set(prog) == {"start_gap", "end_gap"}
    checks = compare.judge(prog, limits())
    assert all(c["ok"] for c in checks.values()), checks


def test_the_float8_reference_fails_the_limits(readings):
    checks = compare.judge(readings[1]["control"], limits())
    assert not any(c["ok"] for c in checks.values()), checks


def test_the_float8_control_refuses_float32_storage(tmp_path):
    case = cut_case(tmp_path)
    path = os.path.join(case, "config.yaml")
    with open(path) as fh:
        doc = yaml.safe_load(fh)
    doc["advanced"]["numerics"]["precision"] = "float32"
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    with pytest.raises(ValueError, match="float32"):
        control_bf16.Float8Reference(case, "cpu", cache=False)


def test_e5m2_rounding_keeps_the_small_weights_g():
    g = torch.tensor([4.0e-4, -1.2e-3, 0.02, 0.0], dtype=torch.bfloat16)
    r = control_bf16.round_e5m2(g)
    assert r.dtype == torch.bfloat16 and bool((r != 0).sum() == 3)
    assert float(((r.float() - g.float()).abs() / g.float().abs().clamp_min(1e-30))
                 [:3].max()) <= 0.125


@pytest.fixture
def counts():
    """spans.COUNTS emptied for the test and restored after it."""
    saved = dict(spans.COUNTS)
    spans.COUNTS.clear()
    yield spans.COUNTS
    spans.COUNTS.clear()
    spans.COUNTS.update(saved)


class _FakeLibcuda:
    """cuGraphGetNodes / cuGraphNodeGetType over one fake graph's node types."""

    def __init__(self, types):
        self.types = types

    def cuGraphGetNodes(self, graph, nodes, n_ref):
        n = n_ref._obj
        if nodes is None:
            n.value = len(self.types)
        else:
            for i in range(n.value):
                nodes[i] = i + 1
        return 0

    def cuGraphNodeGetType(self, node, kind_ref):
        kind_ref._obj.value = self.types[node - 1]
        return 0


# the headline's coarse step as captured: K4, K1 x 2 on L2, (K1 + K2) x 4 on
# L3, three child builds (extraction, planes, the carry's copy) and the
# step record's add; empty and event nodes between them
KERNEL, MEMCPY, MEMSET, EMPTY, EVENT = 0, 1, 2, 5, 7
HEADLINE_STEP = ([KERNEL] * 11 + [KERNEL, KERNEL, MEMCPY] * 3 + [KERNEL]
                 + [EMPTY, EVENT, EMPTY])


def test_node_types_and_device_ops_of_a_fake_graph(monkeypatch):
    monkeypatch.setattr(graphs, "_libcuda", lambda: _FakeLibcuda(HEADLINE_STEP))
    types = graphs.node_types(1234)
    assert types == HEADLINE_STEP
    assert graphs.device_ops(types) == 21
    assert graphs.device_ops([MEMSET, EMPTY, EVENT, 3, 4, 6]) == 1


def test_replays_count_ops_per_coarse_step(counts):
    read = harness.reader("graph_ops_per_step")
    assert read(None) is None
    step = {"counts": {"graph.ops": 21, "graph.steps": 1}}
    pair = {"counts": {"graph.ops": 40, "graph.steps": 2}}
    for g in (step, step, step, pair):
        graphs.replayed(g)
    assert counts["graph.ops"] == 103 and counts["graph.steps"] == 5
    assert read(None) == pytest.approx(103 / 5)


def test_a_libcuda_error_raises(monkeypatch):
    class Bad(_FakeLibcuda):
        def cuGraphNodeGetType(self, node, kind_ref):
            return 400

    monkeypatch.setattr(graphs, "_libcuda", lambda: Bad([KERNEL]))
    with pytest.raises(RuntimeError, match="cuGraphNodeGetType"):
        graphs.node_types(1)


@pytest.mark.cuda
def test_graph_ops_match_the_profiler_on_the_card(tmp_path, counts):
    """On a card: a captured unit of two adds and a copy counts 3 device
    operations a replay; the cut headline's replayed coarse step counts what
    the profiler sees run on the card, within one operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are built with nvcc for "
                    "sm_90a and have no interpret mode")
    dev = torch.device("cuda", 0)
    x, y = torch.zeros(1 << 16, device=dev), torch.empty(1 << 16, device=dev)

    def unit():
        x.add_(1.0)
        x.add_(2.0)
        y.copy_(x)
        return y

    gset = graphs.GraphSet("test")
    for _ in range(4):
        gset.run("u", unit, dev)
    assert counts["graph.ops"] == 9 and counts["graph.steps"] == 3

    counts.clear()
    prog = harness.Program(cut_case(tmp_path), dict(TRAFFIC, call_steps=10), dev,
                           say=lambda m: None)
    states, t, _ = prog.warm_up(prog.warm(SEED), prog.t0)
    per_step = harness.reader("graph_ops_per_step")(None)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize(dev)
    prof.start()
    prog.run(states, t, prog.n_call)
    torch.cuda.synchronize(dev)
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    seen = sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == cuda)
    assert per_step is not None and abs(seen / prog.n_call - per_step) <= 1.0, \
        (seen, per_step)

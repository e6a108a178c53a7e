"""The port's bench entry point (`open_ludwig_torch.bench`) against the root
`bench.py` (the JAX package's) and against the port's batch runner, on the
CPU:

- the headline's case at N=25, 3 levels builds the same levels (interiors,
  offsets, cells, site updates per coarse step) and the same case options
  as the root bench's `_build_sphere_runner` (host builds only; nothing is
  stepped);
- the sweep's resolutions and row options are the root bench's, read from
  its source, and the res-12 row has the JAX builder's cell count;
- the states after `time_runner` equal, bit for bit, the batch runner's
  eager loop over the same (t0, n) calls, float32 and bf16: the bench times
  the runner's own program and skips no step;
- the warm-up runs until a graphed runner replays every key the timed
  calls use, also where an odd batch alternates the buffers;
- the launches a batch must execute, per engine; the sweep-row probe
  (`tools/probe_sweep_rows.py`) at a small size;
- the headline's JSON keys and values, over several builds of its case
  (the median of the builds' medians, min and max over every window); a
  failed sweep row keeps the
  schema, `main` prints the headline last and returns 1; `--device cuda`
  without a card raises.
"""

import ast
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import open_ludwig_tpu.config as jax_config
import open_ludwig_tpu.core.patch as jax_patch
from open_ludwig_tpu.cases import make_case_sphere as make_case_sphere_jax
from open_ludwig_tpu.geometry import load_mesh as load_mesh_jax
from open_ludwig_tpu.scaling import compute_domain_params as domain_params_jax

from open_ludwig_torch import bench
from open_ludwig_torch.ops import cuda_step
from open_ludwig_torch.solver_dense import make_batch_runner_dense

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_BENCH = os.path.join(REPO, "bench.py")


def _root_bench():
    """The root bench.py as a module (its watchdog starts only under
    __main__)."""
    spec = importlib.util.spec_from_file_location("root_bench", ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_function(name: str) -> ast.FunctionDef:
    with open(ROOT_BENCH) as fh:
        tree = ast.parse(fh.read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _literal_kwargs(fn: ast.FunctionDef, callee: str) -> dict:
    """The literal keyword arguments of the call to `callee` inside `fn`."""
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == callee)
    out = {}
    for kw in call.keywords:
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except ValueError:
            pass  # a name: surface_resolution=res, num_levels=num_levels
    return out


@pytest.fixture(scope="module")
def headline_case():
    """The port's headline case and the root bench's, built on the host."""
    mp = pytest.MonkeyPatch()
    got = {}
    build, load = jax_patch.build_patches, jax_config.load_case_config

    def build_patches(*a, **k):
        got["levels"] = build(*a, **k)
        return got["levels"]

    def load_case_config(*a, **k):
        got["cfg"] = load(*a, **k)
        return got["cfg"]

    mp.setattr(jax_patch, "build_patches", build_patches)
    mp.setattr(jax_config, "load_case_config", load_case_config)
    try:
        _, _, total, updates = _root_bench()._build_sphere_runner()
    finally:
        mp.undo()
    return bench.build_sphere_runner(25, 3, "cpu"), got, total, updates


def test_headline_case_equals_root_bench(headline_case):
    port, jax, total, updates = headline_case
    assert [p.interior for p in port.levels] == [tuple(p.interior) for p in jax["levels"]]
    assert [p.lo for p in port.levels] == [tuple(p.lo) for p in jax["levels"]]
    assert [p.level_id for p in port.levels] == [p.level_id for p in jax["levels"]]
    assert (port.total_cells, port.updates_per_coarse) == (total, updates)
    assert (total, updates) == (921856, 2626048)
    # the case options the YAML carries, field by field where both configs
    # have the field (the paths name each package's own temporary case)
    a, b = dataclasses.asdict(port.cfg), dataclasses.asdict(jax["cfg"])
    common = sorted(k for k in set(a) & set(b)
                    if "path" not in k and "dir" not in k and k != "case_name")
    assert len(common) > 40, common
    assert {k: a[k] for k in common} == {k: b[k] for k in common}
    assert (port.cfg.steps, port.cfg.ramp_steps, port.cfg.precision) == (
        400, 200, "bfloat16")


def test_headline_engines_and_launches(headline_case):
    port = headline_case[0]
    # unfused by default: level 3's four sub-steps on K1, K2 after each
    assert port.engines == ["K4", "K1", "K1 + K2"] and not port.run.fused2
    assert bench.batch_launches(port.statics, 1, port.run.fused2) == {
        "stream_collide_flat": 1, "stream_collide": 6, "bouzidi": 4}
    assert bench.batch_launches(port.statics, 1, True) == {
        "stream_collide_flat": 1, "stream_collide": 2, "fused_pair": 2, "bouzidi": 2}
    assert bench.batch_launches(port.statics, 400, False) == {
        "stream_collide_flat": 400, "stream_collide": 800 + 1600, "bouzidi": 1600}


def test_sweep_rows_match_root_bench(tmp_path):
    sweep_fn = _root_function("_sweep")
    loop = next(n for n in ast.walk(sweep_fn) if isinstance(n, ast.For)
                and getattr(n.target, "id", None) == "res")
    assert bench.SWEEP_RES == ast.literal_eval(loop.iter)
    assert bench.ROW_CASE == _literal_kwargs(sweep_fn, "make_case_sphere")
    head = _literal_kwargs(_root_function("_build_sphere_runner"), "make_case_sphere")
    assert (head["steps"], head["ramp_steps"], head["precision"]) == (400, 200, "bfloat16")
    assert (bench.HEADLINE_BATCH, bench.HEADLINE_WINDOWS) == (400, 2400 // 400)

    port = bench.build_row(12, "cpu")
    tmp = str(tmp_path)
    make_case_sphere_jax(tmp, "1M", surface_resolution=12, **bench.ROW_CASE)
    cfg = jax_config.load_case_config(tmp)
    mesh = load_mesh_jax(cfg.stl_path, scale=cfg.stl_scale)
    levels = jax_patch.build_patches(cfg, mesh, domain_params_jax(
        cfg, mesh.min_bounds, mesh.max_bounds))
    assert [p.interior for p in port.levels] == [tuple(p.interior) for p in levels]
    assert port.total_cells == sum(p.n_cells for p in levels) == 1605632
    assert port.updates_per_coarse == port.total_cells
    assert port.engines == ["K1 + K2"]
    # an odd batch: one plain step, then pairs; K2 after each
    assert bench.batch_launches(port.statics, 145, True) == {
        "stream_collide": 1, "fused_pair": 72, "bouzidi": 73}
    assert bench.batch_launches(port.statics, 1, True) == {
        "stream_collide": 1, "bouzidi": 1}
    k5 = [{**s, "engine": "inplace"} for s in port.statics]
    assert bench.batch_launches(k5, 15, False) == {
        "stream_collide_inplace": 15, "bouzidi": 15}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_time_runner_steps_the_batch_runner(precision):
    """The states after `time_runner` equal the eager batch runner's over
    the same (t0, n) calls, bit for bit, and the calls cover t = 1 .. end
    with no gap."""
    kw = dict(surface_resolution=8, num_levels=2, device="cpu", precision=precision)
    timed = bench.build_sphere_runner(**kw)
    w = bench.time_runner(timed.run, timed.states, timed.updates_per_coarse, 4, 3, "cpu")
    assert w.calls == [(1, 4), (5, 4), (9, 4), (13, 4)] and w.warmup == 1
    assert len(w.ms) == len(w.mlups) == 3 and min(w.ms) > 0
    assert w.launches == {}  # the CPU launches no kernel

    ref = bench.build_sphere_runner(**kw)
    run = make_batch_runner_dense(ref.cfg, ref.params, ref.levels, ref.statics,
                                  graphs=False)
    states = ref.states
    for t0, n in w.calls:
        states = run(states, t0, n)
    assert len(states) == len(w.states) == 2
    for a, b in zip(w.states, states):
        for key in ("f", "rho", "vel"):
            assert torch.equal(_bits(a[key]), _bits(b[key])), key
    # the batch moved the flow: not a run that skipped its steps
    assert not torch.equal(states[0]["vel"], torch.zeros_like(states[0]["vel"]))


class _FakeGraphed:
    """A graphed single-level runner's launch accounting: each call runs
    one plain step when n is odd, then n // 2 pairs; every unit flips the
    state between two buffers; a (kind, buffer) key launches eagerly at
    its first use, is captured at its second and replays after;
    `graphed=False` is its eager runner (`graph_set` None)."""

    def __init__(self, graphed=True):
        self.graph_set = object() if graphed else None
        self.uses = {}
        self.buffer = "caller"
        self.log = []

    def unit(self, kind):
        key = (kind, self.buffer)
        self.uses[key] = self.uses.get(key, 0) + 1
        if self.uses[key] <= 2:
            cuda_step.LAUNCHES["fused_pair"] += 1
        self.log.append((key, self.uses[key]))
        self.buffer = "B" if self.buffer == "A" else "A"

    def __call__(self, states, t0, n):
        for kind in ["step"] * (n % 2) + ["pair"] * (n // 2):
            self.unit(kind)
        return states


@pytest.mark.parametrize("batch,calls", [(145, 6), (54, 2), (400, 2), (31, 4)])
def test_warm_up_captures_every_key(batch, calls, monkeypatch):
    monkeypatch.setitem(cuda_step.LAUNCHES, "fused_pair", 0)  # restored after
    run = _FakeGraphed()
    _, got = bench.warm_up(run, [], batch)
    assert got == [(1 + i * batch, batch) for i in range(calls)]
    n = len(run.log)
    for _ in range(4):  # the timed windows: replays only
        run([], 0, batch)
    assert all(uses > 2 for _, uses in run.log[n:])
    _, got = bench.warm_up(_FakeGraphed(graphed=False), [], batch)
    assert got == [(1, batch)]
    _, got = bench.warm_up(_FakeGraphed(), [], batch, t0=9)  # turns' t0
    assert got == [(9 + i * batch, batch) for i in range(calls)]


def test_headline_json_line():
    res = bench.headline("cpu", surface_resolution=8, num_levels=2, batch=2,
                         n_windows=3, builds=2)
    for key in ("metric", "unit", "value", "value_su", "value_ref", "value_su_min",
                "value_su_max", "ms_per_coarse_step", "windows", "cells", "engines",
                "device"):
        assert key in res, key
    assert "vs_baseline" not in res
    assert res["unit"] == "MLUPS" and res["device"] == "cpu"
    assert res["value"] == res["value_su"]
    assert res["value_ref"] == pytest.approx(
        res["value_su"] * res["cells"] / res["updates_per_coarse"], rel=1e-12)
    assert res["value_su_min"] <= res["value_su"] <= res["value_su_max"]
    # the median over the builds of each build's median; min / max over
    # every window of every build
    assert res["windows"] == "3 x 2" and res["builds"] == 2
    assert len(res["window_ms"]) == 2 and all(len(w) == 3 for w in res["window_ms"])
    assert res["build_ms"] == pytest.approx([np.median(w) / 2 for w in res["window_ms"]])
    assert res["ms_per_coarse_step"] == pytest.approx(np.median(res["build_ms"]))
    every = [res["updates_per_coarse"] * 2 / m / 1e3 for w in res["window_ms"] for m in w]
    assert res["value_su_min"] == pytest.approx(min(every))
    assert res["value_su_max"] == pytest.approx(max(every))
    assert res["value_su"] == pytest.approx(np.median(
        [np.median([res["updates_per_coarse"] * 2 / m / 1e3 for m in w])
         for w in res["window_ms"]]))
    assert res["warmup_calls"] == [1, 1]
    assert res["engines"] == ["K4", "K1 + K2"]
    # no device memory on the CPU
    assert all(res[k] is None for k in ("peak_gb", "reserved_gb", "context_gb",
                                         "reserve_gb", "estimate_over_peak"))
    assert res["estimate_gb"] > 0
    json.dumps(res)


def test_failed_row_keeps_schema_and_main_exits_1(monkeypatch, tmp_path, capsys):
    def broken(res, device="cuda"):
        raise MemoryError(f"row {res} does not fit")

    real = bench.headline
    monkeypatch.setattr(bench, "build_row", broken)
    monkeypatch.setattr(bench, "headline", lambda dev: real(
        dev, surface_resolution=8, num_levels=1, batch=2, n_windows=2, builds=1))
    out = tmp_path / "sweep.json"
    rc = bench.main(["--sweep", "--device", "cpu", "--out", str(out)])
    assert rc == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[-1])
    assert head["unit"] == "MLUPS" and head["device"] == "cpu"
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu"
    assert [r["res"] for r in doc["rows"]] == list(bench.SWEEP_RES)
    for row in doc["rows"]:
        assert list(row) == ["res", "cells", "label", "mlups", "mlups_min",
                             "mlups_max", "windows", "engine", "peak_gb",
                             "reserved_gb", "context_gb", "reserve_gb",
                             "estimate_gb", "estimate_over_peak", "error"]
        assert row["mlups"] is None and row["error"].startswith("MemoryError: row ")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.build_sphere_runner(8, 1, "cuda")


def test_probe_sweep_rows_on_cpu():
    """tools.probe_sweep_rows: a row, snapped and unsnapped, each a finest
    K1 level by the card's rule, on the card's schedule (K1 unfused), on K3
    pairs and on K5, in turns."""
    from open_ludwig_torch.tools import probe_sweep_rows

    lines = probe_sweep_rows.main(["--device", "cpu", "--res", "5", "--windows", "1",
                                   "--batch", "2"])
    assert [(ln["res"], ln["snap"], ln["engine"]) for ln in lines] == [
        (5, True, "k1"), (5, False, "k1")]
    snapped, plain = lines
    assert snapped["dims"][2] % 128 == 0 and snapped["cells"] > plain["cells"]
    for ln in lines:
        assert ln["cells"] == int(np.prod(ln["dims"])) and ln["device"] == "cpu"
        assert [t["schedule"] for t in ln["turns"]] == list(probe_sweep_rows.TURNS)
        assert all(t["ms"] > 0 and t["ns_per_cell"] == pytest.approx(
            t["ms"] * 1e6 / ln["cells"]) for t in ln["turns"])

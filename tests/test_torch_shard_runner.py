"""The x-slab multi-device path of the PyTorch port on CPU slabs.

- K2's sharded form (links split by the slab that owns the written cell,
  sources in other slabs read from a halo gathered first): the slabs
  joined are bit-equal to `apply_bouzidi_links` on the whole level, with
  the Bouzidi box split through its middle and in thirds;
- the ghost planes under a mesh: the endpoint slabs assembled from the
  parent's slabs equal one device's bit for bit, and each child slab's
  planes are the x range of the whole planes;
- a 2-level sphere (surface_resolution 8, Bouzidi, wall model, inlet
  noise) through `make_batch_runner_dense(x_mesh=)` at 2 and 3 slabs, float32
  and bf16: every level's f, rho and vel bit-equal to
  `make_batch_runner_dense(fuse2=False)`; from the gathered levels, as
  the runner's events read them, its forces (stress mapping and momentum
  exchange) and flow statistics equal and its flow file byte for byte;
- the port of tests/test_runner_e2e.py:259: `solve_case` with `devices: 2`
  on CPU slabs, checkpointed and resumed under the same sharding, the
  final Cd of the uninterrupted sharded run to 1e-5 and the CSVs holding
  each step once; a single-device checkpoint resumed on 2 slabs ends
  bit-equal to the uninterrupted single-device run;
- `devices: 2` with `--device cuda` raises without a card, and
  `make_x_mesh` raises with the count it found when fewer cards are
  visible; `plan_case` reports per slab.
"""

import csv
import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from open_ludwig_torch import checkpoint as ckpt
from open_ludwig_torch import lattice as lat
from open_ludwig_torch import runner
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.diagnostics import compute_flow_stats
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.io import vtk
from open_ludwig_torch.ops import cuda_step, forces, storage
from open_ludwig_torch.ops.dense_step import apply_bouzidi_links, extract_endpoint_slabs
from open_ludwig_torch.parallel import patch_shard as ps
from open_ludwig_torch.scaling import compute_domain_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere2"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=3,
                     ramp_steps=2, output_freq=100, diag_freq=100,
                     inlet_turbulence=0.02)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    assert len(levels) == 2 and levels[-1].bouzidi is not None
    return cfg, mesh, params, levels


def _random_states(levels, precision, seed):
    rng = np.random.default_rng(seed)
    states = []
    for p in levels:
        sh = tuple(p.interior)
        f = (lat.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
            (27,) + sh))).astype(np.float32)
        states.append({
            "f": storage.encode_f(torch.as_tensor(f), precision),
            "rho": torch.as_tensor((1 + 0.01 * rng.standard_normal(sh)).astype(np.float32)),
            "vel": torch.as_tensor((0.02 * rng.standard_normal((3,) + sh))
                                   .astype(np.float32)),
        })
    return states


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("cut", ["middle", "thirds"])
def test_bouzidi_slabs_equal_whole_level(sphere2, precision, cut):
    cfg, _, _, levels = sphere2
    fine = levels[-1]
    plan = sd.build_patch_statics(cfg, levels)[-1]["bouzidi"]
    X = fine.interior[0]
    lx, bx = plan["lo"][0], plan["dim"][0]
    bounds = ([0, lx + bx // 2, X] if cut == "middle" else
              [0, lx + bx // 3, lx + 2 * bx // 3, X])
    shards = [{"bouzidi": sp} for sp in ps.shard_bouzidi_plan(
        plan, bounds, [torch.device("cpu")] * (len(bounds) - 1))]
    f = _random_states(levels, precision, 11)[-1]["f"]
    parts = [f[:, bounds[i]:bounds[i + 1]].contiguous() for i in range(len(bounds) - 1)]
    halos = ps.bouzidi_halos(shards, parts)
    # the box straddles a cut: links on both sides, reading each other's
    assert sum(sh["bouzidi"] is not None for sh in shards) >= 2
    assert sum(sh["bouzidi"]["n_halo"] for sh in shards if sh["bouzidi"]) > 0
    got = torch.cat([cuda_step.bouzidi(p, sh["bouzidi"], h) if sh["bouzidi"] else p
                     for p, sh, h in zip(parts, shards, halos)], dim=1)
    want = apply_bouzidi_links(f, plan)
    assert _equal(got, want) and not torch.equal(got, f)
    n = sum(len(sh["bouzidi"]["links"]["a"]) for sh in shards if sh["bouzidi"])
    assert n == len(plan["links"]["a"])


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_ghost_planes_under_a_mesh_equal_one_device(sphere2, n, precision):
    cfg, _, _, levels = sphere2
    child, parent = levels[1], levels[0]
    plan = sd.build_patch_statics(cfg, levels)[1]["iface_mm"]
    state = _random_states(levels, precision, 13)[0]
    sh = ps.shard_states([state], ps.make_x_mesh(n, "cpu"))[0]
    b = ps.slab_bounds(parent.interior[0], n)
    got = ps.endpoint_slabs_sharded(plan, sh, b, "cpu")
    want = extract_endpoint_slabs(plan, state)
    for g, w in zip(got, want):
        assert g["g"] == w["g"]
        for key in ("f", "rho", "vel"):
            assert g[key].shape == w[key].shape and _equal(g[key], w[key]), key
    from open_ludwig_torch.ops.dense_step import interface_planes_pair_mm
    dt = storage.f_dtype(precision)
    planes = interface_planes_pair_mm(plan, child, parent, want, want, True,
                                      g_shifted=dt == torch.bfloat16, out_dtype=dt)
    cb = ps.slab_bounds(child.interior[0], n)
    cut = ps.slab_planes(planes, child, cb, [torch.device("cpu")] * n)
    for i, d in enumerate(cut):
        for fc, pl in planes.items():
            if fc == 0 and i != 0 or fc == 1 and i != n - 1:
                assert fc not in d
                continue
            want_pl = pl if fc < 2 else pl[:, :, cb[i]:cb[i + 1]]
            assert d[fc].is_contiguous() and _equal(d[fc], want_pl)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sharded_runner_equals_one_device(sphere2, tmp_path, precision, n):
    cfg, mesh, params, levels = sphere2
    cfg = dataclasses.replace(cfg, precision=precision)
    states = _random_states(levels, precision, 17)
    one = sd.make_batch_runner_dense(cfg, params, levels, sd.build_patch_statics(
        cfg, levels), fuse2=False)
    want = one([dict(s) for s in states], 1, 3)
    xm = ps.make_x_mesh(n, "cpu")
    statics = sd.build_patch_statics(cfg, levels, x_mesh=xm)
    assert [st["bounds"] for st in statics] == [ps.slab_bounds(p.interior[0], n)
                                                for p in levels]
    run = sd.make_batch_runner_dense(cfg, params, levels, statics, x_mesh=xm)
    assert not run.fused2
    got = run(ps.shard_states(states, xm), 1, 3)
    joined = ps.gather_states(got, "cpu")
    for a, b in zip(joined, want):
        for key in ("f", "rho", "vel"):
            assert _equal(a[key], b[key]), key
    # the runner's events read the gathered levels: the same forces,
    # statistics and files as one device's
    sctx = forces.make_force_context_dense(mesh, levels[-1], params)
    mctx = forces.make_mem_context(levels[-1], params, mesh,
                                   g_storage=precision == "bfloat16")
    for fn, ctx in ((forces.compute_aerodynamics, sctx),
                    (forces.compute_aerodynamics_mem, mctx)):
        rs, rw = fn(joined[-1], ctx), fn(want[-1], ctx)
        for k in ("Fx", "Fy", "Fz", "Mx", "My", "Mz", "Cd", "Cl"):
            assert getattr(rs, k) == getattr(rw, k), (fn.__name__, k)
    obstacle = torch.as_tensor(levels[0].obstacle)
    assert compute_flow_stats(joined[0], obstacle) == compute_flow_stats(want[0],
                                                                         obstacle)
    fields = dataclasses.replace(cfg.output_fields, density=True, vorticity=True)
    vtk.export_flow_vtu_patches(str(tmp_path / "a.vtu"), levels, joined, fields)
    vtk.export_flow_vtu_patches(str(tmp_path / "b.vtu"), levels, want, fields)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()


def test_sharded_kernel_log_and_memory_report(sphere2):
    cfg, _, _, levels = sphere2
    xm = ps.make_x_mesh(3, "cpu")
    statics = sd.build_patch_statics(cfg, levels, x_mesh=xm)
    lines = sd.kernel_log_lines(levels, statics, cfg.precision, "cpu", x_mesh=xm)
    assert "K3 off" in lines[0] and len(lines) == 1 + len(levels)
    assert all("sharded form" in ln for ln in lines[1:])
    assert "K2 bouzidi sharded form" in lines[-1]
    rep = sd.hbm_report_patches(levels, statics, cfg.precision, "cpu", x_mesh=xm)
    assert "x mesh of 3 slabs" in rep and "cpu" in rep


@pytest.fixture(scope="module")
def resumable(tmp_path_factory):
    """The case of tests/test_runner_e2e.py:259 (Bouzidi, wall model, bf16,
    diagnostics every 10), cut to surface_resolution 8 for the CPU."""
    d = str(tmp_path_factory.mktemp("resume"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=20,
                     ramp_steps=10, output_freq=100, diag_freq=10,
                     wake_enabled=False, boundary_method="bouzidi",
                     wall_model=True, precision="bfloat16")
    return load_case_config(d).with_overrides(checkpoint_freq=10)


def test_checkpoint_resume_under_sharding(resumable):
    """solve_case on 2 CPU slabs (`devices: 2`), checkpointed, then resumed
    under the same sharding: the resumed run's final Cd is the
    uninterrupted sharded run's to 1e-5, and the CSVs hold each step
    once."""
    cfg = resumable.with_overrides(devices=2)
    assert cfg.devices == 2
    res_full = runner.solve_case(cfg.with_overrides(output_dir="RESULTS_FULL",
                                                    checkpoint_freq=0), device="cpu")
    runner.solve_case(cfg.with_overrides(steps=10), device="cpu")
    res = runner.solve_case(cfg.with_overrides(checkpoint_resume=True), device="cpu")
    assert res.resume_step == 10 and np.isfinite(res.final_forces.Cd)
    assert abs(res.final_forces.Cd - res_full.final_forces.Cd) < 1e-5
    with open(os.path.join(cfg.output_path, "convergence.csv")) as fh:
        steps = [int(r["Step"]) for r in csv.DictReader(fh)]
    assert len(steps) == len(set(steps)) and max(steps) == 20


def test_single_device_checkpoint_resumes_sharded(resumable):
    """A checkpoint written on one device resumes on 2 slabs (the file is
    the global layout either way) and the run ends bit-equal to the
    uninterrupted single-device run (on the CPU the single device's fused
    pairs compute what the unfused sub-steps do)."""
    cfg = resumable.with_overrides(output_dir="RESULTS_MIX")
    full = runner.solve_case(cfg.with_overrides(output_dir="RESULTS_ONE"), device="cpu")
    runner.solve_case(cfg.with_overrides(steps=10), device="cpu")
    ck_dir = os.path.join(cfg.output_path, "checkpoints")
    assert sorted(os.listdir(ck_dir)) == ["ckpt_00000010.npz"]
    res = runner.solve_case(cfg.with_overrides(checkpoint_resume=True, devices=2),
                            device="cpu")
    assert res.resume_step == 10
    assert res.final_forces.Cd == full.final_forces.Cd
    _, a = ckpt.load_checkpoint(os.path.join(ck_dir, "ckpt_00000020.npz"))
    _, b = ckpt.load_checkpoint(os.path.join(
        cfg.with_overrides(output_dir="RESULTS_ONE").output_path, "checkpoints",
        "ckpt_00000020.npz"))
    for x, y in zip(a, b):
        for key in ("f", "rho", "vel"):
            assert _equal(x[key], y[key]), key


def test_devices_on_cuda_without_cards_raise(resumable, monkeypatch):
    cfg = resumable.with_overrides(devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.solve_case(cfg, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main([cfg.case_dir, "--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="requested 2 CUDA devices, 1 visible"):
        ps.make_x_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="requested 2 CUDA devices, 1 visible"):
        runner.resolve_mesh(cfg, torch.device("cuda"), None)
    assert runner.resolve_mesh(cfg.with_overrides(devices=1), torch.device("cuda"),
                               None) is None


def test_plan_reports_per_slab(resumable, caplog):
    with caplog.at_level(logging.INFO, logger="open_ludwig_torch"):
        out = runner.plan_case(resumable.with_overrides(devices=2), device="cpu")
    assert out["capacity"] is None and out["total_cells"] > 0
    assert "x mesh of 2 slabs" in caplog.text and "K3 off" in caplog.text


def test_x_mesh_kinds():
    xm = ps.make_x_mesh(3, "cpu")
    assert xm.size == 3 and xm.virtual and xm.devices == [torch.device("cpu")] * 3
    v = ps.XMesh([torch.device("cuda", 0)] * 2)
    assert v.size == 2 and v.virtual
    with pytest.raises(ValueError):
        ps.XMesh([])
    with pytest.raises(ValueError):
        ps.make_x_mesh(0, "cpu")

"""The port against the benchmark's plain reference on the CPU: the levels
the reference rebuilds from the case's files, its ghost planes, forces and
flow statistics against the program's own ways of computing them, and a
whole run of the harness (set-up, window, check) on tiny cases, held to
the limits of the configurations they stand for."""

import json
import os

import numpy as np
import pytest

from lbm_bench import harness
from lbm_bench.reference.model import Reference


def _limits(config):
    with open(os.path.join(harness.HERE, "configs", config, "limits.json")) as fh:
        return json.load(fh)


def test_reference_levels_equal_the_programs(tiny_case):
    from open_ludwig_torch.config import load_case_config
    from open_ludwig_torch.core.patch import build_patches
    from open_ludwig_torch.geometry import load_mesh
    from open_ludwig_torch.scaling import compute_domain_params

    cfg = load_case_config(tiny_case)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    levels = build_patches(cfg, mesh, compute_domain_params(cfg, mesh.min_bounds,
                                                            mesh.max_bounds))
    ref = Reference(tiny_case, "cpu", cache=False)
    assert len(ref.levels) == len(levels) == 4
    for p, r in zip(levels, ref.levels):
        assert (p.interior, p.lo, p.face_bc, p.tau) == (r.interior, r.lo, r.face_bc, r.tau)
        for key in ("obstacle", "sponge", "wall_dist"):
            assert np.array_equal(getattr(p, key), getattr(r, key)), key
        assert (p.bouzidi is None) == (r.bouzidi is None)
        if p.bouzidi is not None:
            assert np.array_equal(p.bouzidi.q_map, r.bouzidi.q_map)


def test_reference_levels_cache(tiny_case, tmp_path, monkeypatch):
    from lbm_bench.reference import model
    monkeypatch.setattr(model, "CACHE_DIR", str(tmp_path))
    a = Reference(tiny_case, "cpu")
    assert len(os.listdir(tmp_path)) == 1
    b = Reference(tiny_case, "cpu")
    for p, r in zip(a.levels, b.levels):
        assert np.array_equal(p.obstacle, r.obstacle) and np.array_equal(p.sponge, r.sponge)


def _program_state(ref, seed):
    """A perturbed state of every level (the warm start, stepped once)."""
    from lbm_bench import warm
    states = warm.warm_states(ref.obstacles, float(ref.cfg.u_lattice), False, seed,
                              1e-3, 0.05)
    return ref.steps(states, int(ref.cfg.ramp_steps) + 1, 1)


def test_ghost_planes_agree_with_the_programs_matmul_path(tiny_case):
    import torch
    from open_ludwig_torch.ops.dense_step import (
        build_iface_mm_plan, extract_endpoint_slabs, iface_mm_plan_to,
        interface_planes_pair_mm)

    ref = Reference(tiny_case, "cpu", cache=False)
    before = _program_state(ref, 2 ** 31 + 3)
    after = _program_state(ref, 2 ** 31 + 4)
    for lvl in range(len(ref.levels) - 1):
        child, parent = ref.levels[lvl + 1], ref.levels[lvl]
        plan = iface_mm_plan_to(build_iface_mm_plan(child, parent), "cpu")
        mm = interface_planes_pair_mm(plan, child, parent,
                                      extract_endpoint_slabs(plan, before[lvl]),
                                      extract_endpoint_slabs(plan, after[lvl]), True,
                                      g_shifted=False, out_dtype=torch.float32)
        mine = ref.ghost_planes(lvl, before[lvl], after[lvl])
        assert set(mm) == set(mine[0]) and mm
        for face, pl in mm.items():
            for n in (0, 1):
                assert (pl[n] - mine[n][face]).abs().max() <= 1e-5, (lvl, face, n)


def test_plain_forces_and_stats_agree_with_the_programs(tiny_case):
    from open_ludwig_torch import diagnostics
    from open_ludwig_torch.geometry import load_mesh
    from open_ludwig_torch.ops import forces

    ref = Reference(tiny_case, "cpu", cache=False)
    states = _program_state(ref, 2 ** 31 + 5)
    mesh = load_mesh(ref.cfg.stl_path, scale=ref.cfg.stl_scale)
    ctx = forces.make_force_context_dense(mesh, ref.levels[-1], ref.params,
                                          extrapolate=ref.cfg.force_extrapolate)
    prog = forces.compute_aerodynamics(states[-1], ctx)
    mine = ref.forces(states[-1])
    assert max(abs(prog.Cd), abs(prog.Cl)) > 1e-3  # the state loads the sphere
    for c in ("Cd", "Cl", "Cs"):
        assert abs(getattr(prog, c) - getattr(mine, c)) <= 1e-5, c
    prog_s = diagnostics.compute_flow_stats(states[0], ref.statics[0]["obstacle"])
    mine_s = ref.flow_stats(states[0])
    assert prog_s.n_fluid == mine_s.n_fluid
    for s in ("rho_mean", "rho_min", "rho_max", "v_max", "kinetic_energy"):
        assert abs(getattr(prog_s, s) - getattr(mine_s, s)) <= 1e-6 * abs(getattr(mine_s, s))


@pytest.mark.parametrize("case, traffic, config", [
    ("tiny_case", "tiny_traffic", "sphere_re10m"),
    ("tiny_row", "row_traffic", "sphere_64m_row"),
])
def test_a_run_on_the_cpu_is_correct(case, traffic, config, request):
    case_dir = request.getfixturevalue(case)
    traffic = request.getfixturevalue(traffic)
    out = harness.run_case(case_dir, traffic, _limits(config), 2 ** 31 + 5, 0.0, False,
                           "cpu", 0.0, say=lambda m: None)
    checks = out["checks"]
    want = {"start_gap", "end_gap"} | ({"force_gap", "stats_gap"}
                                        if traffic.get("forces_every") else set())
    assert set(checks) == want
    assert all(c["ok"] for c in checks.values()), checks
    rec = out["record"]
    assert rec.coarse_steps >= traffic["call_steps"] and rec.window_s > 0
    spec = harness.load_spec()
    line = harness.result_line({"end_to_end": spec["end_to_end"],
                                "per_layer": spec["per_layer"]}, out, False)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == len(want)
    assert list(line)[-1] == "checks"
    assert line["metrics"]["mlups_su"]["value"] > 0

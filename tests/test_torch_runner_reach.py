"""The port's runner on the shipped case families, against the JAX runner.

Each case runs through the JAX package's `solve_case` (on the CPU: its XLA
path) and the port's `solve_case(device="cpu")` from ONE perturbed state:
random f around rest on every level, written as a JAX checkpoint at step 0
that the JAX runner resumes from and the port resumes from after
`convert.checkpoint_from_jax` (the pattern of
`test_mem_forces_csv_matches_jax_runner`).  Both runners write a
checkpoint at the last step; the final states per level must agree within
2e-5 in float32 (`tests/test_patch_pallas.py:509`, multi-level coarse
steps) and 2e-3 in bf16 (decoded f; `tests/test_patch_pallas.py:400`).

Why not from rest: at rest both runners agree on rho_min to 1e-7, but
their forces.csv rows do not.  The JAX state's rho at a sampled cell is
1 - 2.6e-7 (the float32 roundoff of summing the 27 weights), the port's is
exactly 1.0, and `pressure_scale` (~3e5 at Re~1M) turns that roundoff into
a uniform 0.077 Pa: forces from rest compare roundoff, not the solvers.

forces.csv rows (stress mapping, `ops.forces._surface_stresses`) are held
within what the two final states' difference can move them: a triangle's
force moves by at most area x pressure_scale x (5/3 |d rho| + nu/d_wall x
(rho |d u| sqrt(3) + |u| |d rho|)) (the extrapolated pressure reads two
cells with a factor of at most 2; the shear is linear in u), summed over
the triangles, times 2 for the rows' earlier states and half models
doubled; moments with each triangle's arm.  That bound is the sum of
|per-triangle contribution| of a state difference, as `checks.mem_float64`
bounds momentum exchange, and each test asserts it is small beside the
forces it bounds.

The cases: the cube (2 levels), the wing at 5 degrees (2 levels), the
symmetric half model (2 levels, Bouzidi and the wall model, its Bouzidi box
on the finest level's y = 0 mirror face), a 3-level sphere with the wake
box, a 4-level sphere, `num_levels: 0` and `auto_levels` (the same level
count as the JAX `compute_domain_params`), one of them in bf16.  Each of
the six `CASES/` configs builds its plan in the port.
"""

import csv
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import checkpoint as ckpt_jax
from open_ludwig_tpu import lattice as lat_jax
from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh as load_mesh_jax
from open_ludwig_tpu.runner import solve_case as solve_case_jax
from open_ludwig_tpu.scaling import compute_domain_params as domain_params_jax

from open_ludwig_torch import checkpoint as ckpt
from open_ludwig_torch import checks, convert, runner
from open_ludwig_torch.cases import make_case_cube, make_case_sphere, make_case_wing
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.ops import dense_step, forces, storage
from open_ludwig_torch.scaling import compute_domain_params

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
STEPS = 4
EVERY = 2  # forces, diagnostics and checkpoints
TOL = {"float32": 2e-5, "bfloat16": 2e-3}
COMMON = dict(steps=STEPS, ramp_steps=2, output_freq=100, diag_freq=EVERY)


def _edits(symmetric=False, **high_re):
    """A config edit (`checks.edit_config`): the half model's mirror plane,
    `advanced.high_re` keys (min_coarse_blocks 1 lets a res-8 sphere keep
    3-4 levels)."""
    return {"advanced.refinement.symmetric_analysis": symmetric,
            **{f"advanced.high_re.{k}": v for k, v in high_re.items()}}


BZ = dict(wall_model=True, boundary_method="bouzidi", wake_enabled=False)
CASE_SPECS = {
    "cube_2lev": (make_case_cube, dict(surface_resolution=8, num_levels=2,
                                       wake_enabled=False), _edits()),
    "wing5_2lev": (lambda d, **o: make_case_wing(d, alpha_deg=5.0, **o),
                   dict(surface_resolution=10, num_levels=2, wake_enabled=False,
                        boundary_method="bouzidi"), _edits()),
    "half_2lev": (make_case_sphere, dict(surface_resolution=8, num_levels=2, **BZ),
                  _edits(True, min_coarse_blocks=1)),
    "sphere_3lev_wake": (make_case_sphere, dict(surface_resolution=8, num_levels=3,
                                                wake_enabled=True),
                         _edits(min_coarse_blocks=1)),
    "sphere_4lev": (make_case_sphere, dict(surface_resolution=8, num_levels=4,
                                           wake_enabled=False),
                    _edits(min_coarse_blocks=1)),
    "levels_zero": (make_case_sphere, dict(surface_resolution=8, num_levels=0,
                                           wake_enabled=False), _edits()),
    "levels_auto": (make_case_sphere, dict(surface_resolution=8, num_levels=0,
                                           wake_enabled=False),
                    _edits(auto_levels=True, max_levels=2)),
    "half_2lev_bf16": (make_case_sphere, dict(surface_resolution=8, num_levels=2,
                                              precision="bfloat16", **BZ),
                       _edits(True, min_coarse_blocks=1)),
}


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _jax_start(levels_j, precision, rng):
    """Random f around rest on each level's interior, the padding at rest."""
    W = lat_jax.W.astype(np.float32)
    states = []
    for p in levels_j:
        X, Y, Z = p.interior
        f = np.broadcast_to(W[:, None, None, None], (27,) + tuple(p.padded)).copy()
        f[:, :X, :Y, :Z] *= 1 + 0.01 * rng.standard_normal((27, X, Y, Z))
        rho = f.sum(0)
        vel = (np.einsum("kxyz,ck->cxyz", f, lat_jax.C) / rho).astype(np.float32)
        fj = jnp.asarray(f)
        if precision == "bfloat16":
            fj = (fj - jnp.asarray(W)[:, None, None, None]).astype(jnp.bfloat16)
        states.append({"f": fj, "rho": jnp.asarray(rho), "vel": jnp.asarray(vel)})
    return states


def _force_bounds(state_j, state_t, ctx):
    """Per component, what the finest level's state difference can move the
    stress-mapped force and moment (module docstring), plus both packages'
    float32 summation (1e-5 x the sum of |per-triangle force|,
    `checks.MEM_REL`), in N and N m."""
    d_rho = (state_j["rho"] - state_t["rho"]).abs().reshape(-1).double()
    d_vel = (state_j["vel"] - state_t["vel"]).reshape(3, -1).double().norm(dim=0)
    rho = state_t["rho"].reshape(-1).double()
    speed = state_t["vel"].reshape(3, -1).double().norm(dim=0)
    i1, i2 = ctx.cell_idx, ctx.cell_idx2
    fac = torch.zeros_like(ctx.dn1, dtype=torch.float64)
    if ctx.extrapolate:
        fac = torch.where(ctx.found2, torch.clamp(
            ctx.dn1 / torch.clamp(ctx.dn2 - ctx.dn1, min=0.25), 0.0, 2.0).double(), fac)
    nu = (ctx.tau_molecular - 0.5) / 3.0
    wd = torch.clamp(ctx.wall_dist, min=0.01).double()
    dp = ((1 + fac) * d_rho[i1] + fac * d_rho[i2]) / 3.0
    dtau = nu / wd * (rho[i1] * d_vel[i1] + speed[i1] * d_rho[i1])
    area = ctx.areas.double() * ctx.pressure_scale
    moved = torch.where(ctx.found, area * (dp + dtau), torch.zeros_like(dp))
    res = forces.compute_aerodynamics(state_t, ctx)
    size = ctx.areas.double() * torch.from_numpy(
        np.abs(res.pressure_map) + np.linalg.norm(res.shear_map, axis=0))
    per_tri = moved + checks.MEM_REL * size
    arm = (ctx.centers - ctx.moment_center[:, None]).double().norm(dim=0)
    half = 2.0 if ctx.symmetric else 1.0
    return half * float(per_tri.sum()), half * float((per_tri * arm).sum())


def _run_both(case_dir, tmp, precision):
    """Both runners from one perturbed state, a checkpoint at every forces
    row.  Returns (the port's config, the JAX levels, per row step: the JAX
    and the port's states in the port's layout, forces rows J and T)."""
    cfg_j = load_case_config_jax(case_dir).with_overrides(
        output_dir="RJ", checkpoint_resume=True, checkpoint_freq=EVERY)
    mesh_j = load_mesh_jax(cfg_j.stl_path, scale=cfg_j.stl_scale)
    params_j = domain_params_jax(cfg_j, mesh_j.min_bounds, mesh_j.max_bounds)
    levels_j = build_patches_jax(cfg_j, mesh_j, params_j)
    p0 = ckpt_jax.save_checkpoint(os.path.join(cfg_j.output_path, "checkpoints"), 0,
                                  _jax_start(levels_j, precision,
                                             np.random.default_rng(12)))
    solve_case_jax(cfg_j)

    cfg = load_case_config(case_dir).with_overrides(
        output_dir="RT", checkpoint_resume=True, checkpoint_freq=EVERY)
    convert.checkpoint_from_jax(p0, levels_j, os.path.join(cfg.output_path,
                                                           "checkpoints"))
    res = runner.solve_case(cfg, device="cpu")
    assert res.resume_step == 0 and res.steps == STEPS
    states = {0: (None, ckpt.load_checkpoint(os.path.join(
        cfg.output_path, "checkpoints", "ckpt_00000000.npz"))[1])}
    for step in range(EVERY, STEPS + 1, EVERY):
        name = f"ckpt_{step:08d}.npz"
        pj = convert.checkpoint_from_jax(
            os.path.join(cfg_j.output_path, "checkpoints", name), levels_j,
            os.path.join(tmp, "jax_port_layout"))
        states[step] = (ckpt.load_checkpoint(pj)[1], ckpt.load_checkpoint(
            os.path.join(cfg.output_path, "checkpoints", name))[1])
    return (cfg, levels_j, states,
            _rows(os.path.join(cfg_j.output_path, "forces.csv")),
            _rows(os.path.join(cfg.output_path, "forces.csv")))


@pytest.mark.parametrize("case", list(CASE_SPECS))
def test_runner_matches_jax_runner(tmp_path, case):
    make, opts, edit = CASE_SPECS[case]
    d = str(tmp_path / "case")
    make(d, **COMMON, **opts)
    checks.edit_config(d, edit)
    precision = opts.get("precision", "float32")
    cfg, levels_j, states, rows_j, rows_t = _run_both(d, str(tmp_path), precision)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    assert [tuple(p.interior) for p in levels] == [tuple(p.interior) for p in levels_j]
    want_levels = {"cube_2lev": 2, "wing5_2lev": 2, "half_2lev": 2,
                   "half_2lev_bf16": 2, "sphere_3lev_wake": 3, "sphere_4lev": 4}
    if case in want_levels:
        assert params.num_levels == want_levels[case]
    else:  # num_levels: 0 / auto_levels: the JAX package's level count
        cfg_j = load_case_config_jax(d)
        mesh_j = load_mesh_jax(cfg_j.stl_path, scale=cfg_j.stl_scale)
        pj = domain_params_jax(cfg_j, mesh_j.min_bounds, mesh_j.max_bounds)
        assert cfg.num_levels == 0 and params.num_levels == pj.num_levels >= 1
        if case == "levels_auto":
            assert cfg.auto_levels and params.num_levels <= 2
    if case.startswith("half"):
        # the Bouzidi box lies on the finest level's y = 0 mirror face
        plan = dense_step.build_bouzidi_dense_plan(levels[-1], cfg.q_min_threshold)
        assert cfg.symmetric_analysis and plan is not None
        assert plan["lo"][1] == 0, plan["lo"]
    if case == "sphere_3lev_wake":
        assert cfg.wake_enabled

    tol = TOL[precision]
    final_j, final_t = states[STEPS]
    start = states.pop(0)[1]
    for lvl, (a, b, s0) in enumerate(zip(final_j, final_t, start)):
        assert a["f"].dtype == b["f"].dtype == storage.f_dtype(precision)
        for key in ("f", "rho", "vel"):
            x, y = a[key], b[key]
            if key == "f":
                x, y = storage.decode_f(x), storage.decode_f(y)
            err = float((x - y).abs().max())
            assert err < tol, (case, lvl, key, err)
        # the run moved the state by more than the tolerance
        moved = storage.decode_f(b["f"]) - storage.decode_f(s0["f"])
        assert float(moved.abs().max()) > 2 * tol, (case, lvl)

    ctx = forces.make_force_context_dense(mesh, levels[-1], params,
                                          extrapolate=cfg.force_extrapolate)
    steps = [int(r["Step"]) for r in rows_t]
    assert steps == [int(r["Step"]) for r in rows_j] == sorted(states)
    for rj, rt in zip(rows_j, rows_t):
        sj, st = states[int(rt["Step"])]
        bound_f, bound_m = _force_bounds(sj[-1], st[-1], ctx)
        for names, bnd in ((("Fx_N", "Fy_N", "Fz_N"), bound_f),
                           (("Mx_Nm", "My_Nm", "Mz_Nm"), bound_m)):
            for name in names:
                a, b = float(rj[name]), float(rt[name])
                # plus the CSV's 7 significant digits
                assert abs(a - b) <= bnd + 1e-6 * abs(a), (case, rt["Step"], name,
                                                          a, b, bnd)
        # the bound is small beside the force (the wing's is its lift)
        size = max(abs(float(rt[name])) for name in ("Fx_N", "Fy_N", "Fz_N"))
        assert size > 10 * bound_f, (case, rt, bound_f)


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "CASES"))))
def test_shipped_case_plans(name, caplog):
    """`runner --plan` of each shipped case builds its levels, statics and
    report in the port, the levels the JAX package's `build_patches` makes."""
    d = os.path.join(REPO, "CASES", name)
    with caplog.at_level(logging.INFO, logger="open_ludwig_torch"):
        out = runner.plan_case(load_case_config(d), device="cpu")
    cfg_j = load_case_config_jax(d)
    mesh_j = load_mesh_jax(cfg_j.stl_path, scale=cfg_j.stl_scale)
    params_j = domain_params_jax(cfg_j, mesh_j.min_bounds, mesh_j.max_bounds)
    levels_j = build_patches_jax(cfg_j, mesh_j, params_j)
    assert out["total_cells"] == sum(p.n_cells for p in levels_j)
    assert out["updates_per_coarse"] == sum(p.n_cells * 2 ** (p.level_id - 1)
                                            for p in levels_j)
    assert "estimated total" in caplog.text
    assert caplog.text.count("[engine] level") == len(levels_j)


@pytest.mark.parametrize("num_levels", [1, 2])
def test_batch_runner_takes_over_its_list(tmp_path, num_levels, monkeypatch):
    """A batch of coarse steps keeps no more than the current states alive:
    the runner replaces the entries of the list it is given (the JAX
    runner's donated states), so the batch's first state is freed once the
    first pair of sub-steps has replaced it.  Before, the caller's list kept
    it alive for the whole batch: a third copy of the finest level's state
    at the peak (53.2 GB against an estimate of 36.1 GB for the 242.5M-cell
    row on the card)."""
    import gc
    import weakref

    from open_ludwig_torch import solver_dense as sd

    d = str(tmp_path)
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=num_levels,
                     steps=4, ramp_steps=2, output_freq=100, diag_freq=100,
                     wake_enabled=False)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels = build_patches(cfg, mesh, params)
    statics = sd.build_patch_statics(cfg, levels)
    run = sd.make_batch_runner_dense(cfg, params, levels, statics, fuse2=True)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels]
    first = weakref.ref(states[-1]["f"])
    alive = []
    fused = sd.fused_pair

    def watch(*args, **kw):
        alive.append(first() is not None)
        return fused(*args, **kw)

    monkeypatch.setattr(sd, "fused_pair", watch)
    gc.disable()  # reference counting alone must free it
    try:
        out = run(states, 1, 6)
    finally:
        gc.enable()
    # one K3 pair per two coarse steps on one level, per coarse step on two
    pairs = 3 if num_levels == 1 else 6
    assert out is states and alive == [True] + [False] * (pairs - 1), alive
    assert first() is None

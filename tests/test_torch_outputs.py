"""The port's force and output modules against the JAX package.

Same inputs, made from a numpy seed, through both packages:

- momentum exchange: the port's link set (`make_mem_context`) equals JAX's
  `make_mem_context` link for link and in order (JAX's padded indices
  mapped with `convert.cell_index_from_jax`), with equal triangle ids,
  weights, directions, arms and rest flux, on a 2-level sphere and a
  `symmetric_analysis` half model;
- `compute_aerodynamics_mem` against JAX's on random f (float32) and bf16
  g-storage, and against a float64 evaluation and the reference test's
  numpy loop (`tests/test_forces_io.py:359-420`): F, M and the force map
  within 1e-5 x the sum of |link contribution| x force_scale per component
  (`checks.MEM_REL`; a float32 summation-order bound: a plain relative
  bound is wrong for a sum that cancels), and on the states after two
  coarse steps of the 2-level slice run by both packages (the reflected
  slots at solid cells are the ones JAX writes);
- the writers byte for byte: `write_vtu` with `COMPRESS` on and off,
  `export_flow_vtu_patches` on a 2-level case with vorticity,
  `export_surface_vtu` and `export_surface_loads_csv` from the same maps,
  and `read_vtu` decoding what they wrote;
- `control_volume_force` (equal, and raising on a state that is not 3-D)
  and `lattice.equilibrium_np` (equal).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from open_ludwig_tpu import diagnostics as diag_jax
from open_ludwig_tpu import lattice as lat_jax
from open_ludwig_tpu import solver_dense as sd_jax
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.io import csv_out as csv_jax
from open_ludwig_tpu.io import vtk as vtk_jax
from open_ludwig_tpu.ops import forces as forces_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import checks, convert, diagnostics
from open_ludwig_torch import lattice as lat
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.io import csv_out, vtk
from open_ludwig_torch.ops import forces

torch.set_num_threads(1)


def _case(d, symmetric=False, **over):
    opts = dict(surface_resolution=8, num_levels=2, steps=3, ramp_steps=2,
                output_freq=100, diag_freq=100, inlet_turbulence=0.02)
    opts.update(over)
    make_case_sphere(d, "1M", **opts)
    if symmetric:
        path = os.path.join(d, "config.yaml")
        with open(path) as fh:
            cfgd = yaml.safe_load(fh)
        cfgd["advanced"]["refinement"]["symmetric_analysis"] = True
        with open(path, "w") as fh:
            yaml.safe_dump(cfgd, fh)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params, build_patches_jax(cfg, mesh, params), \
        build_patches(cfg, mesh, params)


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    return _case(str(tmp_path_factory.mktemp("sphere2")))


@pytest.fixture(scope="module")
def half1(tmp_path_factory):
    out = _case(str(tmp_path_factory.mktemp("half1")), symmetric=True,
                surface_resolution=10, num_levels=1, wake_enabled=False)
    assert out[2].symmetric
    return out


CASES = ["sphere2", "half1"]


def _random_f(patch_j, precision, rng):
    """A JAX level's f (padded) around rest, in the storage type."""
    f = (lat_jax.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
        (27,) + patch_j.padded))).astype(np.float32)
    return storage_jax.encode_f(jnp.asarray(f), precision)


@pytest.mark.parametrize("case", CASES)
def test_mem_context_matches_jax(case, request):
    cfg, mesh, params, levels_j, levels_t = request.getfixturevalue(case)
    pj, pt = levels_j[-1], levels_t[-1]
    for g_storage in (False, True):
        cj = forces_jax.make_mem_context(pj, params, mesh, g_storage=g_storage)
        ct = forces.make_mem_context(pt, params, mesh, g_storage=g_storage)
        assert ct.n_links == cj.n_links > 100 and ct.g_storage == g_storage
        assert ct.idx_out.dtype == ct.idx_in.dtype == torch.int64
        Nj, Nt = int(np.prod(pj.padded)), pt.n_cells
        for key in ("idx_out", "idx_in"):
            idx = np.asarray(getattr(cj, key)).astype(np.int64)
            k, cell = idx // Nj, idx % Nj
            want = k * Nt + convert.cell_index_from_jax(cell, pj.padded, pj.interior)
            assert np.array_equal(getattr(ct, key).numpy(), want), key
        for key in ("tri", "w_k", "c", "r"):
            assert np.array_equal(getattr(ct, key).numpy(),
                                  np.asarray(getattr(cj, key))), key
        for key in ("rest_F", "rest_M", "rest_F_tri"):
            assert np.array_equal(getattr(ct, key), getattr(cj, key)), key
        for key in ("n_tri", "force_scale", "q_inf", "area_ref", "chord_ref",
                    "symmetric"):
            assert getattr(ct, key) == getattr(cj, key), key


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_mem_forces_match_jax(case, precision, request):
    cfg, mesh, params, levels_j, levels_t = request.getfixturevalue(case)
    pj, pt = levels_j[-1], levels_t[-1]
    bf16 = precision == "bfloat16"
    fj = _random_f(pj, precision, np.random.default_rng(7))
    cj = forces_jax.make_mem_context(pj, params, mesh, g_storage=bf16)
    ct = forces.make_mem_context(pt, params, mesh, g_storage=bf16)
    st = convert.state_from_jax({"f": np.asarray(fj), "rho": np.ones(pj.padded),
                                 "vel": np.zeros((3,) + pj.padded)}, pj)
    assert st["f"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    rj = forces_jax.compute_aerodynamics_mem({"f": fj}, cj)
    rt = forces.compute_aerodynamics_mem(st, ct)
    ref = checks.mem_float64(st["f"], ct)
    # JAX's float32 sums and the port's against the same float64 value
    assert checks.mem_errors(rt, ref)["ok"], checks.mem_errors(rt, ref)
    assert checks.mem_errors(rj, ref)["ok"], checks.mem_errors(rj, ref)
    for i, name in enumerate(("Fx", "Fy", "Fz")):
        assert abs(getattr(rt, name) - getattr(rj, name)) <= ref["F_bound"][i], name
    for i, name in enumerate(("Mx", "My", "Mz")):
        assert abs(getattr(rt, name) - getattr(rj, name)) <= ref["M_bound"][i], name
    assert np.all(np.abs(rt.force_map - rj.force_map) <= ref["map_bound"])
    assert abs(rt.Fx) > 10 * ref["F_bound"][0]  # a force, not noise
    F_ref = ct.q_inf * ct.area_ref
    assert rt.Cd == rt.Fx / F_ref and rt.Cl == rt.Fz / F_ref
    if params.symmetric:
        assert rt.Fy == rt.Mx == rt.Mz == 0.0


def test_mem_matches_numpy_loop(half1):
    """The reference test's direct loop over the obstacle mask (its own
    link scan, moment arms and nearest triangles), in float64, on bf16
    g-storage of the half model."""
    from scipy.spatial import cKDTree

    cfg, mesh, params, _, levels_t = half1
    p = levels_t[-1]
    rng = np.random.default_rng(1234)
    X, Y, Z = p.interior
    f = torch.from_numpy((0.01 * rng.standard_normal((27, X, Y, Z)))
                         .astype(np.float32)).to(torch.bfloat16)
    ctx = forces.make_mem_context(p, params, mesh, g_storage=True)
    res = forces.compute_aerodynamics_mem({"f": f}, ctx)
    ref = checks.mem_float64(f, ctx)
    fh = f.double().numpy()
    obs = p.obstacle
    F, M = np.zeros(3), np.zeros(3)
    F_tri = np.zeros((3, mesh.n_triangles))
    mc = np.asarray(params.moment_center, np.float64)
    lo = np.asarray(p.lo, np.float64)
    kd = cKDTree(mesh.centers + np.asarray(params.mesh_offset)[None, :])
    bidx = np.argwhere(obs)
    lo_b = np.maximum(bidx.min(0) - 1, 0)
    hi_b = np.minimum(bidx.max(0) + 2, [X, Y, Z])
    n = 0
    for gx in range(lo_b[0], hi_b[0]):
        for gy in range(lo_b[1], hi_b[1]):
            for gz in range(lo_b[2], hi_b[2]):
                if obs[gx, gy, gz]:
                    continue
                for k in range(27):
                    cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
                    if cx == cy == cz == 0:
                        continue
                    nx, ny, nz = gx + cx, gy + cy, gz + cz
                    if not (0 <= nx < X and 0 <= ny < Y and 0 <= nz < Z):
                        continue
                    if not obs[nx, ny, nz]:
                        continue
                    c = np.array([cx, cy, cz], np.float64)
                    w = float(lat.W[k])
                    f_out = fh[k, gx, gy, gz] + w
                    f_in = fh[int(lat.OPP[k]), nx, ny, nz] + w
                    dF = (f_out + f_in) * c
                    F += dF
                    mid = (np.array([gx, gy, gz], np.float64) + lo + 0.5
                           + 0.5 * c) * p.dx
                    M += np.cross(mid - mc, dF)
                    F_tri[:, int(kd.query(mid)[1])] += dF
                    n += 1
    assert n == ctx.n_links
    s = params.force_scale
    F, M, F_tri = F * s, M * s, F_tri * s
    F = np.array([2 * F[0], 0.0, 2 * F[2]])
    M = np.array([0.0, 2 * M[1], 0.0])
    got = np.array([res.Fx, res.Fy, res.Fz])
    gotM = np.array([res.Mx, res.My, res.Mz])
    # the loop's float64 sums differ from the vectorized float64 ones in
    # order only; the port's float32 sums within the stated bound
    assert np.all(np.abs(got - F) <= ref["F_bound"] + 1e-9 * np.abs(F)), (got, F)
    assert np.all(np.abs(gotM - M) <= ref["M_bound"] + 1e-9 * np.abs(M)), (gotM, M)
    assert np.all(np.abs(res.force_map - F_tri) <= ref["map_bound"] + 1e-9 * np.abs(F_tri))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_mem_after_steps_matches_jax(sphere2, precision):
    """Two coarse steps of the 2-level slice through both packages from one
    random state: the states' link slots agree within the slice's tolerance
    (2e-5 float32, 2e-3 bf16), so the port writes JAX's reflected
    populations at solid cells, and MEM on them agrees within the
    summation bound plus that tolerance carried through the links."""
    cfg, mesh, params, levels_j, levels_t = sphere2
    cfg = dataclasses.replace(cfg, precision=precision)
    bf16 = precision == "bfloat16"
    rng = np.random.default_rng(21)
    states_j = []
    for p in levels_j:
        states_j.append({
            "f": _random_f(p, precision, rng),
            "rho": jnp.asarray((1 + 0.01 * rng.standard_normal(p.padded))
                               .astype(np.float32)),
            "vel": jnp.asarray((0.02 * rng.standard_normal((3,) + p.padded))
                               .astype(np.float32)),
        })
    states_t = [convert.state_from_jax({k: np.asarray(v) for k, v in s.items()}, p)
                for s, p in zip(states_j, levels_j)]
    run_j = sd_jax.make_batch_runner_dense(
        cfg, params, levels_j, sd_jax.build_patch_statics(cfg, levels_j),
        use_pallas=False)
    states_j = run_j(states_j, np.int32(1), 2)
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t,
                                       sd.build_patch_statics(cfg, levels_t))
    states_t = run_t(states_t, 1, 2)
    pj = levels_j[-1]
    cj = forces_jax.make_mem_context(pj, params, mesh, g_storage=bf16)
    ct = forces.make_mem_context(levels_t[-1], params, mesh, g_storage=bf16)
    rj = forces_jax.compute_aerodynamics_mem(states_j[-1], cj)
    rt = forces.compute_aerodynamics_mem(states_t[-1], ct)
    # the link slots of both states (JAX's trimmed to the interior)
    f_j = convert.trim(np.asarray(states_j[-1]["f"]).astype(np.float32), pj.interior)
    f_t = convert.to_numpy(states_t[-1]["f"])
    tol = 2e-3 if bf16 else 2e-5
    for key in ("idx_out", "idx_in"):
        idx = getattr(ct, key).numpy()
        d = np.abs(f_t.reshape(-1)[idx] - f_j.reshape(-1)[idx]).max()
        assert d < tol, (key, d)
    ref = checks.mem_float64(states_t[-1]["f"], ct)
    assert checks.mem_errors(rt, ref)["ok"], checks.mem_errors(rt, ref)
    carry = tol * 2 * np.abs(ct.c.double().numpy()).sum(axis=1) * ct.force_scale
    got = np.array([rt.Fx, rt.Fy, rt.Fz])
    want = np.array([rj.Fx, rj.Fy, rj.Fz])
    assert np.all(np.abs(got - want) <= ref["F_bound"] + carry), (got, want, carry)
    assert abs(rt.Fx) > 0


def _write_both(tmp_path, name, write_j, write_t):
    pj, pt = str(tmp_path / f"{name}_jax.vtu"), str(tmp_path / f"{name}_port.vtu")
    write_j(pj)
    write_t(pt)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        bj, bt = a.read(), b.read()
    return pj, pt, bj, bt


@pytest.mark.parametrize("compress", [True, False])
def test_write_vtu_bytes_match_jax(tmp_path, monkeypatch, compress):
    monkeypatch.setattr(vtk_jax, "COMPRESS", compress)
    monkeypatch.setattr(vtk, "COMPRESS", compress)
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((40, 3)).astype(np.float32)
    conn = rng.integers(0, 40, (11, 8))
    data = {"A": rng.standard_normal(11).astype(np.float32),
            "B": rng.standard_normal((11, 3)),
            "C": rng.integers(0, 3, 11).astype(np.uint8),
            "D": np.arange(11, dtype=np.int32)}
    pj, pt, bj, bt = _write_both(
        tmp_path, "w", lambda p: vtk_jax.write_vtu(p, pts, conn, 11, data),
        lambda p: vtk.write_vtu(p, pts, conn, 11, data))
    assert bj == bt
    got = vtk.read_vtu(pt)
    assert np.array_equal(got["Points"], pts)
    assert np.array_equal(got["connectivity"], conn.astype(np.int32).reshape(-1))
    for key, arr in data.items():
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("compress", [True, False])
def test_flow_vtu_bytes_match_jax(sphere2, tmp_path, monkeypatch, compress):
    monkeypatch.setattr(vtk_jax, "COMPRESS", compress)
    monkeypatch.setattr(vtk, "COMPRESS", compress)
    cfg, mesh, params, levels_j, _ = sphere2
    fields = dataclasses.replace(cfg.output_fields, density=True, vorticity=True)
    rng = np.random.default_rng(11)
    states_j = [{
        "rho": (1 + 0.01 * rng.standard_normal(p.padded)).astype(np.float32),
        "vel": (0.02 * rng.standard_normal((3,) + p.padded)).astype(np.float32),
        "f": np.zeros((27,) + p.padded, np.float32),
    } for p in levels_j]
    states_j[0]["vel"][0, 2, 3, 4] = np.nan  # scrubbed alike
    levels_p = [convert.level_from_jax(p) for p in levels_j]
    states_p = [convert.state_from_jax(s, p) for s, p in zip(states_j, levels_j)]
    fields_j = type(cfg.output_fields)(**dataclasses.asdict(fields))
    pj, pt, bj, bt = _write_both(
        tmp_path, "flow",
        lambda p: vtk_jax.export_flow_vtu_patches(p, levels_j, states_j, fields_j),
        lambda p: vtk.export_flow_vtu_patches(p, levels_p, states_p, fields))
    assert bj == bt
    got = vtk.read_vtu(pt)
    n = len(got["Level"])
    assert got["Velocity"].shape == (n, 3) and got["Vorticity"].shape == (n,)
    assert len(got["connectivity"]) == 8 * n and np.isfinite(got["Velocity"]).all()
    # the coarse cells under the child patch are left out
    kept = [int((got["Level"] == p.level_id).sum()) for p in levels_p]
    assert kept[-1] == levels_p[-1].n_cells and 0 < kept[0] < levels_p[0].n_cells


def test_surface_outputs_match_jax(sphere2, tmp_path):
    """The surface file and the surface-load table from the same stress maps
    (the port's stress mapping of one state)."""
    cfg, mesh, params, levels_j, levels_t = sphere2
    p = levels_t[-1]
    rng = np.random.default_rng(13)
    st = {"rho": torch.from_numpy((1 + 0.01 * rng.standard_normal(p.interior))
                                  .astype(np.float32)),
          "vel": torch.from_numpy((0.02 * rng.standard_normal((3,) + p.interior))
                                  .astype(np.float32))}
    ctx = forces.make_force_context_dense(mesh, p, params)
    fr = forces.compute_aerodynamics(st, ctx)
    args = (mesh.vertices, mesh.normals, mesh.areas, fr.pressure_map, fr.shear_map)
    pj, pt, bj, bt = _write_both(
        tmp_path, "surface", lambda q: vtk_jax.export_surface_vtu(q, *args),
        lambda q: vtk.export_surface_vtu(q, *args))
    assert bj == bt
    got = vtk.read_vtu(pt)
    assert np.array_equal(got["Pressure_Pa"], fr.pressure_map.astype(np.float32))
    assert len(got["Area_m2"]) == mesh.n_triangles
    targs = (mesh.centers, mesh.normals, mesh.areas, fr.pressure_map, fr.shear_map,
             params.mesh_offset)
    cj, ct = str(tmp_path / "loads_jax.csv"), str(tmp_path / "loads_port.csv")
    csv_jax.export_surface_loads_csv(cj, *targs)
    csv_out.export_surface_loads_csv(ct, *targs)
    with open(cj) as a, open(ct) as b:
        lines = b.read()
        assert a.read() == lines
    assert len(lines.splitlines()) == mesh.n_triangles + 1


def test_control_volume_force_matches_jax(sphere2):
    cfg, mesh, params, levels_j, levels_t = sphere2
    pj, pt = levels_j[-1], levels_t[-1]
    rng = np.random.default_rng(17)
    st_j = {"rho": (1 + 0.01 * rng.standard_normal(pj.padded)).astype(np.float32),
            "vel": (0.02 * rng.standard_normal((3,) + pj.padded)).astype(np.float32)}
    st_t = {k: torch.from_numpy(convert.trim(v, pj.interior).copy())
            for k, v in st_j.items()}
    want = diag_jax.control_volume_force(st_j, pj, params, 1.225, margin=2)
    got = diagnostics.control_volume_force(st_t, pt, params, 1.225, margin=2)
    assert np.array_equal(got, want) and np.abs(got).max() > 0
    got_np = diagnostics.control_volume_force(
        {k: v.numpy() for k, v in st_t.items()}, pt, params, 1.225, margin=2)
    assert np.array_equal(got_np, want)
    # a state that is not the level's 3-D interior is refused
    flat = {"rho": st_t["rho"].reshape(-1), "vel": st_t["vel"].reshape(3, -1)}
    with pytest.raises(ValueError, match="control_volume_force"):
        diagnostics.control_volume_force(flat, pt, params, 1.225)
    padded = {k: torch.from_numpy(v) for k, v in st_j.items()}
    if pj.padded != pj.interior:
        with pytest.raises(ValueError, match="control_volume_force"):
            diagnostics.control_volume_force(padded, pt, params, 1.225)


def test_equilibrium_np_matches_jax():
    rng = np.random.default_rng(19)
    rho = 1 + 0.05 * rng.standard_normal((4, 5))
    u = 0.05 * rng.standard_normal((3, 4, 5))
    got = lat.equilibrium_np(rho, *u)
    assert got.shape == (4, 5, 27) and got.dtype == np.float64
    assert np.array_equal(got, lat_jax.equilibrium_np(rho, *u))
    assert np.allclose(got.sum(-1), rho)

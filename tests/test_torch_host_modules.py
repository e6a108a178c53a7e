"""The port's own host modules against the JAX package's, on the same inputs.

open_ludwig_torch carries copies of the numpy modules it needs (lattice,
config, geometry, scaling, cases, native, domain, core.patch) so that it
imports nothing of open_ludwig_tpu.  Each copy must give the reference's
arrays: booleans, integers, boxes and config fields exactly, floats
bit for bit.  The Bouzidi q of the port's freshly built native library
equals the reference's committed one here (float16 q_map, exact), also
where the port's ray cast clips the geometry's reach to the grid; the
port's per-axis sponge equals the reference's evaluation over whole
coordinate grids.

Native and numpy preprocessing differ in q by up to 2e-3
(tests/test_native.py:50), so each domain builder is compared on one path
at a time, and each case asserts which path both sides took.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from open_ludwig_tpu import cases as cases_jax
from open_ludwig_tpu import config as config_jax
from open_ludwig_tpu import geometry as geometry_jax
from open_ludwig_tpu import lattice as lattice_jax
from open_ludwig_tpu import native as native_jax
from open_ludwig_tpu import scaling as scaling_jax
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.domain import bouzidi as bouzidi_jax
from open_ludwig_tpu.domain import builder as builder_jax
from open_ludwig_tpu.domain import fields as fields_jax
from open_ludwig_tpu.domain import voxelize as voxelize_jax

from open_ludwig_torch import cases, checks, config, geometry, lattice, native, scaling
from open_ludwig_torch.core import patch as patch_mod
from open_ludwig_torch.core.patch import box_sponge, build_patches
from open_ludwig_torch.domain import bouzidi, fields, voxelize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_DIRS = sorted(glob.glob(os.path.join(REPO, "CASES", "*", "config.yaml")))


@pytest.mark.parametrize("name", ["Q", "CS2", "C_X", "C_Y", "C_Z", "C", "OPP",
                                  "W", "W64", "MIRROR_Y", "MIRROR_Z", "PI_MAT",
                                  "REG_MAT"])
def test_lattice_tables_equal(name):
    got, want = getattr(lattice, name), getattr(lattice_jax, name)
    assert np.asarray(got).dtype == np.asarray(want).dtype, name
    assert np.array_equal(got, want), name


def _same_dataclass(a, b):
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_mesh(a, b):
    for key in ("vertices", "normals", "areas", "centers"):
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and np.array_equal(x, y), key
    assert (a.min_bounds, a.max_bounds) == (b.min_bounds, b.max_bounds)


def test_all_bundled_cases_found():
    assert len(CASE_DIRS) == 6, CASE_DIRS


@pytest.mark.parametrize("path", CASE_DIRS,
                         ids=[os.path.basename(os.path.dirname(p)) for p in CASE_DIRS])
def test_bundled_case_config_mesh_and_domain_equal(path):
    """Each CASES/*/config.yaml: the CaseConfig, its STL through load_mesh
    and the domain parameters, through both packages."""
    case_dir = os.path.dirname(path)
    cfg = config.load_case_config(case_dir)
    cfg_j = config_jax.load_case_config(case_dir)
    _same_dataclass(cfg, cfg_j)
    assert (cfg.stl_path, cfg.reference_area, cfg.effective_force_output_freq) == \
        (cfg_j.stl_path, cfg_j.reference_area, cfg_j.effective_force_output_freq)
    mesh = geometry.load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    mesh_j = geometry_jax.load_mesh(cfg_j.stl_path, scale=cfg_j.stl_scale)
    _same_mesh(mesh, mesh_j)
    _same_dataclass(
        scaling.compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds),
        scaling_jax.compute_domain_params(cfg_j, mesh_j.min_bounds, mesh_j.max_bounds))


@pytest.mark.parametrize("over", [
    dict(symmetric_analysis=True),
    dict(domain_tile_snap=True),
    dict(num_levels=0, auto_levels=True),
    dict(reference_length_for_meshing=0.0, reference_dimension="z",
         reference_area_full_model=0.0, reference_chord=0.0),
], ids=["symmetric", "tile_snap", "auto_levels", "derived_refs"])
def test_domain_params_equal_with_overrides(over):
    case_dir = os.path.join(REPO, "CASES", "sphere_re1m")
    cfg = dataclasses.replace(config.load_case_config(case_dir), **over)
    cfg_j = dataclasses.replace(config_jax.load_case_config(case_dir), **over)
    mesh = geometry.load_mesh(cfg.stl_path)
    _same_dataclass(
        scaling.compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds),
        scaling_jax.compute_domain_params(cfg_j, mesh.min_bounds, mesh.max_bounds))


def test_load_mesh_ascii_equal(tmp_path):
    verts = geometry.make_cube(0.7, center=(0.1, -0.2, 0.3))
    path = str(tmp_path / "cube_ascii.stl")
    with open(path, "w") as fh:
        fh.write("solid cube\n")
        for tri in verts:
            fh.write("facet normal 0 0 0\n outer loop\n")
            for v in tri:
                fh.write(f"  vertex {v[0]:.9e} {v[1]:.9e} {v[2]:.9e}\n")
            fh.write(" endloop\nendfacet\n")
        fh.write("endsolid cube\n")
    _same_mesh(geometry.load_mesh(path, scale=2.0),
               geometry_jax.load_mesh(path, scale=2.0))


@pytest.mark.parametrize("name", ["cube", "icosphere", "naca_wing"])
def test_synthetic_geometry_equal(name):
    kw = {"naca_wing": dict(alpha_deg=5.0), "icosphere": dict(subdiv=2),
          "cube": dict(edge=0.5)}[name]
    fn = "make_" + name
    assert np.array_equal(getattr(geometry, fn)(**kw), getattr(geometry_jax, fn)(**kw))


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


@pytest.mark.parametrize("maker,args,kw", [
    ("make_case_sphere", ("1M",), dict(surface_resolution=16, num_levels=3,
                                       precision="bfloat16", wake_enabled=True)),
    ("make_case_sphere", ("10M",), dict(domain_tile_snap=True, checkpoint_freq=5)),
    ("make_case_cube", (), dict(surface_resolution=12, num_levels=2)),
    ("make_case_wing", (5.0,), dict(surface_resolution=10, num_levels=2)),
], ids=["sphere_1M", "sphere_10M", "cube", "wing_5deg"])
def test_make_case_writes_identical_files(tmp_path, maker, args, kw):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    getattr(cases, maker)(a, *args, **kw)
    getattr(cases_jax, maker)(b, *args, **kw)
    got, want = _files(a), _files(b)
    assert sorted(got) == sorted(want) and "config.yaml" in got
    for name in want:
        assert got[name] == want[name], name


def test_make_case_rejects_unknown_option(tmp_path):
    with pytest.raises(ValueError, match="unknown case option"):
        cases.make_case_sphere(str(tmp_path), "1M", no_such_option=1)


@pytest.fixture(scope="module")
def sphere_grid():
    """The sphere mesh placed in a 40^3 grid with dx = 1/16."""
    verts = geometry.make_icosphere(0.5, center=(1.25, 1.25, 1.25), subdiv=3)
    return verts, 1.0 / 16, (40, 40, 40)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_voxelize_dense_equal(sphere_grid, use_native):
    verts, dx, dims = sphere_grid
    if use_native:
        assert native.available() and native_jax.available()
        assert native.voxelize_sat(verts, dx, dims) is not None
    got = voxelize.voxelize_dense(verts, dx, dims, use_native=use_native)
    want = voxelize_jax.voxelize_dense(verts, dx, dims, use_native=use_native)
    assert got.dtype == want.dtype == bool and got.any()
    assert np.array_equal(got, want)


def test_flood_fill_and_wall_distance_equal(sphere_grid):
    verts, dx, dims = sphere_grid
    shell = voxelize_jax.voxelize_dense(verts, dx, dims, use_native=False)
    active = np.ones(dims, bool)
    got = voxelize.flood_fill_dense(shell, active, 0)
    want = voxelize_jax.flood_fill_dense(shell, active, 0)
    assert np.array_equal(got, want) and got.sum() > shell.sum()
    d, d_j = fields.wall_distance_dense(got, dx), fields_jax.wall_distance_dense(want, dx)
    assert d.dtype == d_j.dtype == np.float32
    assert np.array_equal(d, d_j) and (d < 100.0).any()


@pytest.mark.parametrize("symmetric", [False, True])
def test_sponge_for_cells_equal(symmetric):
    rng = np.random.default_rng(7)
    p = rng.uniform(-0.1, 1.1, (3, 4096)) * np.array([[8.0], [4.0], [4.0]])
    got = fields.sponge_for_cells(*p, (8.0, 4.0, 4.0), 0.1, symmetric)
    want = fields_jax.sponge_for_cells(*p, (8.0, 4.0, 4.0), 0.1, symmetric)
    assert got.dtype == want.dtype == np.float32 and (got > 0).any()
    assert np.array_equal(got, want)


# boxes of a 128 x 64 x 64 tunnel (dx = 1/16 of an (8, 4, 4) domain) with a
# non-zero lo and odd extents, and the sponges each one reaches
SPONGE_BOXES = {
    "inlet_lateral_floor": ((1, 1, 3), (17, 21, 13)),
    "outlet_top_back": ((101, 41, 47), (27, 23, 17)),
    "whole_tunnel": ((0, 0, 0), (128, 64, 64)),
    "interior": ((41, 19, 23), (9, 11, 7)),
}


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("box", list(SPONGE_BOXES))
def test_box_sponge_equals_meshgrid(box, symmetric):
    """The per-axis sponge of a patch box against the reference's
    evaluation over the box's whole (X, Y, Z) coordinate grids."""
    lo, interior = SPONGE_BOXES[box]
    dx, size = 1.0 / 16, (8.0, 4.0, 4.0)
    gx, gy, gz = np.meshgrid(*(lo[a] + np.arange(n) for a, n in enumerate(interior)),
                             indexing="ij")
    want = fields_jax.sponge_for_cells((gx + 0.5) * dx, (gy + 0.5) * dx, (gz + 0.5) * dx,
                                       size, 0.1, symmetric)
    got = box_sponge(np.asarray(lo, np.int64), interior, dx, size, 0.1, symmetric)
    assert got.shape == want.shape == interior and got.dtype == want.dtype == np.float32
    assert got.flags.c_contiguous
    assert np.array_equal(got, want)
    assert (want > 0).any() == (box != "interior")


def _shipped_bouzidi_inputs(root, name, symmetric):
    """The finest level's compute_bouzidi arguments as the port's builder
    passes them, for the shipped case CASES/`name` at surface resolution 8."""
    d = checks.copy_case(name, os.path.join(root, name + ("_half" if symmetric else "")), {
        "basic.surface_resolution": 8, "basic.num_levels": 2,
        "advanced.refinement.symmetric_analysis": symmetric,
        "advanced.high_re.min_coarse_blocks": 1})
    cfg = config.load_case_config(d)
    assert cfg.surface_resolution == 8 and cfg.symmetric_analysis == symmetric
    calls = []

    def spy(verts, dx, dims, active):
        calls.append((verts, dx, tuple(dims), active))
        return bouzidi._empty()

    mesh = geometry.load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = scaling.compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(patch_mod, "compute_bouzidi", spy)
        build_patches(cfg, mesh, params)
    return calls[-1]


def _block_active(dims, seed):
    """A partly false active mask by 8-cell blocks, as the blocks builder
    passes it."""
    nb = [-(-n // 8) for n in dims]
    blocks = np.random.default_rng(seed).random(nb) < 0.6
    full = blocks.repeat(8, 0).repeat(8, 1).repeat(8, 2)
    return np.ascontiguousarray(full[:dims[0], :dims[1], :dims[2]])


# (geometry, whether its reach is clipped by the grid)
BOUZIDI_CASES = {"sphere": False, "sphere_across_faces": True, "half_model_y0": True,
                 "sphere_block_active": False, "wing_5deg": None, "cube": None}


@pytest.fixture(scope="module")
def bouzidi_inputs(sphere_grid, tmp_path_factory):
    verts, dx, dims = sphere_grid
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        if name == "sphere":
            active = np.ones(dims, bool)
            active[:4] = False  # entries only in active cells
            cache[name] = (verts, dx, dims, active)
        elif name == "sphere_across_faces":  # through x = 0 and z = Z
            moved = geometry.make_icosphere(0.5, center=(0.2, 1.25, 2.4), subdiv=3)
            cache[name] = (moved, dx, dims, np.ones(dims, bool))
        elif name == "sphere_block_active":
            cache[name] = (verts, dx, dims, _block_active(dims, 3))
        else:  # the shipped cases' finest level; the half model cut at y = 0
            case = {"half_model_y0": ("sphere_re1m", True)}.get(name, (name, False))
            cache[name] = _shipped_bouzidi_inputs(str(tmp_path_factory.mktemp("bz")), *case)
        return cache[name]

    return get


@pytest.mark.parametrize("case", list(BOUZIDI_CASES))
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_compute_bouzidi_equal(bouzidi_inputs, case, use_native):
    verts, dx, dims, active = bouzidi_inputs(case)
    if use_native:
        assert native.available() and native_jax.available()
        corner, q, tri = native.bouzidi_raycast(verts, dx, dims)
        ext = q.shape[:3]
        assert q.shape == tri.shape == ext + (27,)
        assert all(0 <= c and c + e <= n for c, e, n in zip(corner, ext, dims))
        clipped = any(c == 0 or c + e == n for c, e, n in zip(corner, ext, dims))
        if BOUZIDI_CASES[case] is not None:
            assert clipped == BOUZIDI_CASES[case]
        if case == "half_model_y0":
            assert corner[1] == 0
    got = bouzidi.compute_bouzidi(verts, dx, dims, active, use_native=use_native)
    want = bouzidi_jax.compute_bouzidi(verts, dx, dims, active, use_native=use_native)
    assert got.n_boundary_cells == want.n_boundary_cells > 0
    for key in ("cell_gx", "cell_gy", "cell_gz", "q_map", "tri_map"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_compute_bouzidi_beyond_the_grid(use_native):
    """A geometry whose reach misses the grid: an empty box, no cells."""
    verts = geometry.make_icosphere(0.5, center=(1.25, 1.25, 4.0), subdiv=2)
    dx, dims = 1.0 / 16, (40, 40, 40)
    if use_native:
        corner, q, tri = native.bouzidi_raycast(verts, dx, dims)
        assert q.shape == tri.shape == (0, 0, 0, 27)
    active = np.ones(dims, bool)
    got = bouzidi.compute_bouzidi(verts, dx, dims, active, use_native=use_native)
    want = bouzidi_jax.compute_bouzidi(verts, dx, dims, active, use_native=use_native)
    assert got.n_boundary_cells == want.n_boundary_cells == 0


@pytest.mark.parametrize("method,bouzidi_levels", [("bouzidi", 1), ("bouzidi", 2),
                                                   ("simple", 1)])
def test_should_use_bouzidi_equal(method, bouzidi_levels):
    cfg = config.CaseConfig(boundary_method=method, bouzidi_levels=bouzidi_levels)
    for lvl in range(1, 5):
        assert bouzidi.should_use_bouzidi(lvl, 4, cfg) == \
            builder_jax.should_use_bouzidi(lvl, 4, cfg)


PATCH_CASES = {
    "sphere_3lvl_wake": ("make_case_sphere", ("1M",),
                         dict(surface_resolution=16, num_levels=3, wake_enabled=True)),
    "sphere_1lvl": ("make_case_sphere", ("1M",),
                    dict(surface_resolution=8, num_levels=1, wall_model=False)),
    "cube": ("make_case_cube", (), dict(surface_resolution=12, num_levels=2)),
    "wing": ("make_case_wing", (5.0,), dict(surface_resolution=10, num_levels=2)),
}
_REF_LEVELS = {}


def _patch_case(name, root):
    maker, args, kw = PATCH_CASES[name]
    d = os.path.join(root, name)
    getattr(cases, maker)(d, *args, **kw)
    cfg = config.load_case_config(d)
    mesh = geometry.load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    return cfg, mesh, scaling.compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)


@pytest.mark.parametrize("flat_coarse", ["auto", "on", "off"])
@pytest.mark.parametrize("name", list(PATCH_CASES))
def test_build_patches_equal_reference_interior(tmp_path_factory, name, flat_coarse):
    """The port's levels against the reference's build_patches(flat_coarse=
    "off", devices=1) cut to its interior: boxes, faces, tau, static fields
    and Bouzidi data; the port's builder ignores flat_coarse."""
    if name not in _REF_LEVELS:
        cfg, mesh, params = _patch_case(name, str(tmp_path_factory.mktemp("ref")))
        cfg_j = config_jax.load_case_config(cfg.case_dir)
        cfg_j = dataclasses.replace(cfg_j, flat_coarse="off", devices=1)
        _REF_LEVELS[name] = (cfg, mesh, params, build_patches_jax(cfg_j, mesh, params))
    cfg, mesh, params, ref = _REF_LEVELS[name]
    port = build_patches(dataclasses.replace(cfg, flat_coarse=flat_coarse), mesh, params)
    assert len(port) == len(ref) == params.num_levels
    for p, r in zip(port, ref):
        X, Y, Z = r.interior
        assert (p.level_id, p.dx, p.tau, p.lo, p.interior, p.face_bc) == \
            (r.level_id, r.dx, r.tau, r.lo, r.interior, r.face_bc)
        assert p.padded == p.interior
        for key in ("obstacle", "sponge", "wall_dist"):
            got, want = getattr(p, key), getattr(r, key)[:X, :Y, :Z]
            assert got.shape == (X, Y, Z) and got.dtype == want.dtype, key
            assert np.array_equal(got, want), key
        assert (p.bouzidi is None) == (r.bouzidi is None)
        if r.bouzidi is not None:
            for key in ("cell_gx", "cell_gy", "cell_gz", "q_map", "tri_map"):
                assert np.array_equal(getattr(p.bouzidi, key), getattr(r.bouzidi, key)), key
    assert port[-1].bouzidi is not None and port[-1].bouzidi.n_boundary_cells > 0

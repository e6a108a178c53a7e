"""The port's blocks-layout host modules against the JAX package's.

`open_ludwig_torch.domain.topology`, `domain.builder` and `core.plan` are
the port's own numpy copies of the JAX package's: every array must come
out equal (booleans and integers exactly, floats bit for bit).
`core.state` moves the plans to the device (int64 indices); its statics
must hold the same values, and `hbm_report` must count what they hold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.core import plan as plan_jax
from open_ludwig_tpu.domain import builder as builder_jax
from open_ludwig_tpu.domain import topology as topo_jax
from open_ludwig_tpu.geometry import load_mesh as load_mesh_jax

from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core import plan, state
from open_ludwig_torch.domain import builder
from open_ludwig_torch.domain import topology as topo
from open_ludwig_torch.geometry import load_mesh, make_icosphere

torch.set_num_threads(2)


def _masks():
    """The masks of tests/test_domain.py:18-60, and a random one."""
    single = np.zeros((5, 5, 5), bool)
    single[2, 2, 2] = True
    octet = np.zeros((4, 4, 4), bool)
    octet[1, 1, 1] = True
    centre = np.zeros((8, 8, 8), bool)
    centre[4, 4, 4] = True
    rand = np.random.default_rng(5).random((7, 6, 5)) < 0.15
    return {"single": single, "octet": octet, "centre": centre,
            "ones": np.ones((3, 3, 3), bool), "random": rand}


MASKS = _masks()


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(MASKS))
def test_topology_functions_equal(name):
    """Every topology function of one mask through both packages."""
    m = MASKS[name]
    for fn in ("dilate26", "complete_siblings", "ensure_parent_coverage"):
        _same(getattr(topo, fn)(m), getattr(topo_jax, fn)(m))
    for layers in (1, 2):
        _same(topo.add_halo_with_siblings(m, layers),
              topo_jax.add_halo_with_siblings(m, layers))
    coords = topo.blocks_from_mask(m)
    _same(coords, topo_jax.blocks_from_mask(m))
    _same(topo.mask_from_blocks(coords, m.shape),
          topo_jax.mask_from_blocks(coords, m.shape))
    ptr = topo.build_block_pointer(coords, m.shape)
    _same(ptr, topo_jax.build_block_pointer(coords, m.shape))
    _same(topo.build_neighbor_table(coords, ptr),
          topo_jax.build_neighbor_table(coords, ptr))
    # the coarser level of this mask: prune_orphans keeps blocks with a parent
    parent = np.random.default_rng(6).random(tuple((d + 1) // 2 for d in m.shape)) < 0.5
    _same(topo.prune_orphans(m, parent), topo_jax.prune_orphans(m, parent))
    wake_lo, wake_hi = np.array([4.0, 3.0, 2.0]), np.array([30.0, 20.0, 16.0])
    fine = tuple(2 * d for d in m.shape)
    _same(topo.wake_children_mask(coords, 1.0, wake_lo, wake_hi, fine),
          topo_jax.wake_children_mask(coords, 1.0, wake_lo, wake_hi, fine))


def test_geometry_active_mask_equal(tmp_path):
    """Blocks overlapping a sphere's triangles, through both packages'
    meshes."""
    from open_ludwig_torch.geometry import save_binary_stl

    path = str(tmp_path / "s.stl")
    save_binary_stl(path, make_icosphere(0.5, center=(0.0, 0.0, 0.0), subdiv=3))
    mesh, mesh_j = load_mesh(path), load_mesh_jax(path)
    offset = np.array([2.1, 1.7, 1.9])
    for dx, dims in ((0.1, (6, 5, 5)), (0.05, (12, 10, 10))):
        got = topo.geometry_active_mask(mesh, dx, offset, dims)
        _same(got, topo_jax.geometry_active_mask(mesh_j, dx, offset, dims))
        assert got.any()


CASES = {
    "sphere2_wake": dict(surface_resolution=12, num_levels=2, wake_enabled=True),
    "sphere1": dict(surface_resolution=8, num_levels=1, wake_enabled=False),
}
_BUILT = {}


def _case(name, tmp_path_factory):
    """The case's levels through both packages' setup_case."""
    if name not in _BUILT:
        d = str(tmp_path_factory.mktemp(name))
        make_case_sphere(d, "1M", steps=4, ramp_steps=2, **CASES[name])
        cfg, cfg_j = load_case_config(d), load_case_config_jax(d)
        _, params, levels = builder.setup_case(cfg)
        _, params_j, levels_j = builder_jax.setup_case(cfg_j)
        _BUILT[name] = (cfg, params, levels, params_j, levels_j)
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_setup_case_levels_equal(tmp_path_factory, name):
    """LevelGeometry field by field: ids, dx/dt/tau, block grid, coords,
    pointer, neighbour table, obstacle, sponge, wall distance and the
    Bouzidi data; the same number of levels as the domain parameters."""
    cfg, params, levels, params_j, levels_j = _case(name, tmp_path_factory)
    assert len(levels) == len(levels_j) == params.num_levels
    assert [f.name for f in dataclasses.fields(levels[0])] == \
        [f.name for f in dataclasses.fields(levels_j[0])]
    for g, gj in zip(levels, levels_j):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(gj, f.name)
            if f.name == "bouzidi":
                assert (a is None) == (b is None)
                if a is not None:
                    for key in ("cell_gx", "cell_gy", "cell_gz", "q_map", "tri_map"):
                        _same(getattr(a, key), getattr(b, key))
            elif isinstance(b, np.ndarray):
                _same(a, b)
            else:
                assert a == b, f.name
    assert builder.verify_parent_coverage(levels) == \
        builder_jax.verify_parent_coverage(levels_j)
    if name == "sphere2_wake":
        assert levels[-1].bouzidi is not None and levels[-1].bouzidi.n_boundary_cells


@pytest.mark.parametrize("name", list(CASES))
def test_stream_and_bouzidi_plans_equal(tmp_path_factory, name):
    """build_stream_plan and build_bouzidi_plan of every level, array by
    array; the device statics hold the same values as int64; hbm_report
    counts the statics' bytes."""
    cfg, params, levels, params_j, levels_j = _case(name, tmp_path_factory)
    states, statics = state.build_all(cfg, params, levels)
    for i, (g, gj) in enumerate(zip(levels, levels_j)):
        par, par_j = (levels[i - 1], levels_j[i - 1]) if i else (None, None)
        tau_p = params.tau_levels[i - 1] if i else 0.5
        scale = 2 ** i
        dims = (params.nx_coarse * scale, params.ny_coarse * scale,
                params.nz_coarse * scale)
        sp = plan.build_stream_plan(g, par, tau_p, *dims)
        sj = plan_jax.build_stream_plan(gj, par_j, tau_p, *dims)
        for f in dataclasses.fields(sj):
            a, b = getattr(sp, f.name), getattr(sj, f.name)
            if isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    _same(x, y)
            elif isinstance(b, np.ndarray):
                _same(a, b)
            else:
                assert a == b, f.name
        assert sp.sizes[4] == (0 if i == 0 else len(sp.parent_k)) and \
            (i == 0 or sp.sizes[4] > 0)
        dev_plan = statics[i]["plan"]
        for key in ("scatter_dst", "scatter_perm", "gather_src", "parent_idx"):
            t = dev_plan[key]
            assert t.dtype == torch.int64
            assert np.array_equal(t.numpy(), getattr(sj, key))
        bp = plan.build_bouzidi_plan(g, cfg.q_min_threshold)
        bj = plan_jax.build_bouzidi_plan(gj, cfg.q_min_threshold)
        assert (bp is None) == (bj is None) == (statics[i]["bouzidi"] is None)
        if bj is not None:
            for f in dataclasses.fields(bj):
                _same(getattr(bp, f.name), getattr(bj, f.name))
                assert np.array_equal(statics[i]["bouzidi"][f.name].numpy(),
                                      getattr(bj, f.name))
        assert states[i]["f"].shape == (27, g.n_blocks, 512)
    rows, total, trans = state.hbm_estimate(levels, statics)
    held = sum(t.numel() * t.element_size()
               for st in statics
               for t in (list(st["plan"].values()) + list(st["vel_dst"])
                         + list(st["vel_src"]) + [st["obstacle"], st["sponge"],
                                                  st["wall_dist"]]
                         + (list(st["bouzidi"].values()) if st["bouzidi"] else []))
               if isinstance(t, torch.Tensor))
    n_cells = sum(g.n_cells for g in levels)
    assert total == held + n_cells * 124 + trans
    report = state.hbm_report(levels, statics)
    assert f"level {levels[-1].level_id}: {levels[-1].n_blocks} blocks" in report

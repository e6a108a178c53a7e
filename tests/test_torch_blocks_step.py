"""The blocks layout's step and scheduler against the JAX package's, and
against the port's own patch layout.

`open_ludwig_torch.ops.stream_collide` (the in-block roll, the fix-up
gather/scatter, inlet noise, the parent's trilinear interpolation with
f_neq rescale, the collision, Bouzidi) and `solver.make_coarse_step` take
the same float32 inputs, made from a numpy seed, as the JAX package's
eager functions.  Tolerances are the reference's (ROADMAP.md): one step
1e-5, Bouzidi 1e-6, multi-level coarse steps 2e-5 per level, the
equilibrium fixed point 1e-7, and the two layouts of one single-level
case 5e-6 after 4 steps (tests/test_layout_equivalence.py:40).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.core import state as state_jax
from open_ludwig_tpu.domain import builder as builder_jax
from open_ludwig_tpu.domain import topology as topo_jax
from open_ludwig_tpu.ops import stream_collide as sc_jax
from open_ludwig_tpu.solver import make_coarse_step as make_coarse_step_jax

from open_ludwig_torch import lattice as lat
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import CaseConfig, load_case_config
from open_ludwig_torch.core import state
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.domain import builder
from open_ludwig_torch.domain import topology as topo
from open_ludwig_torch.ops import stream_collide as sc
from open_ludwig_torch.solver import _parent_view, make_coarse_step
from open_ludwig_torch.solver_dense import (
    build_patch_statics,
    init_patch_state,
    make_coarse_step_dense,
)

torch.set_num_threads(2)


def _dense_level(pkg_topo, pkg_builder, dims, obstacle, sponge, wall_d, tau):
    """One fully dense level of `dims` blocks, built by one package."""
    coords = pkg_topo.blocks_from_mask(np.ones(dims, bool))
    ptr = pkg_topo.build_block_pointer(coords, dims)
    return pkg_builder.LevelGeometry(
        level_id=1, dx=1.0, dt=1.0, tau=tau, dims=dims, coords=coords,
        block_ptr=ptr, neighbor_table=pkg_topo.build_neighbor_table(coords, ptr),
        obstacle=pkg_builder._dense_to_blocks(obstacle, coords),
        sponge=pkg_builder._dense_to_blocks(sponge, coords).astype(np.float32),
        wall_dist=pkg_builder._dense_to_blocks(wall_d, coords).astype(np.float32),
        bouzidi=None)


def _stub_params(geo, tau):
    class P:  # the domain parameters build_level_static reads
        nx_coarse = geo.dims[0] * 8
        ny_coarse = geo.dims[1] * 8
        nz_coarse = geo.dims[2] * 8
        tau_levels = (tau,)
    return P


def _to_blocks(dense, coords):
    """(C, X, Y, Z) or (X, Y, Z) -> (C, nb, 512) / (nb, 512)."""
    if dense.ndim == 3:
        return builder._dense_to_blocks(dense, coords)
    return np.stack([builder._dense_to_blocks(d, coords) for d in dense])


def _to_dense(blocked, coords, dims):
    out = np.zeros(blocked.shape[:-2] + tuple(8 * d for d in dims), blocked.dtype)
    lf = np.arange(512)
    gx = coords[:, 0, None] * 8 + (lf % 8)[None, :]
    gy = coords[:, 1, None] * 8 + ((lf // 8) % 8)[None, :]
    gz = coords[:, 2, None] * 8 + (lf // 64)[None, :]
    out[..., gx, gy, gz] = blocked
    return out


def _max_diff(got: torch.Tensor, want) -> float:
    return float(np.abs(got.numpy() - np.asarray(want)).max())


@pytest.mark.parametrize(
    "wall_model,sponge_blend,inlet_turb",
    [(False, False, 0.0), (True, True, 0.05), (False, True, 0.0)],
)
def test_single_level_step_matches_jax(rng, wall_model, sponge_blend, inlet_turb):
    """Two sub-steps of a dense 2x2x2-block level (the inputs of
    tests/test_stream_collide.py:76: an obstacle blob, a sponge ramp, two
    near-wall cells; every boundary type, inlet noise) through both
    packages: f, rho and vel within 1e-5."""
    dims, X, tau = (2, 2, 2), 16, 0.52
    f0 = (lat.W64[:, None, None, None]
          * (1.0 + 0.05 * rng.standard_normal((27, X, X, X)))).astype(np.float32)
    vel0 = (0.02 * rng.standard_normal((3, X, X, X))).astype(np.float32)
    obstacle = np.zeros((X, X, X), bool)
    obstacle[6:9, 7:9, 7:10] = True
    sponge = np.zeros((X, X, X), np.float32)
    sponge[13:, :, :] = np.linspace(0.1, 0.9, 3)[:, None, None]
    wall_d = np.full((X, X, X), 100.0, np.float32)
    wall_d[5, 7, 7], wall_d[9, 8, 8] = 1.2, 0.8
    args = (dims, obstacle, sponge, wall_d, tau)
    geo = _dense_level(topo, builder, *args)
    geo_j = _dense_level(topo_jax, builder_jax, *args)
    cfg = CaseConfig(q_min_threshold=0.001)
    static = state.build_level_static(geo, None, cfg, _stub_params(geo, tau))
    static_j = state_jax.build_level_static(geo_j, None, cfg, _stub_params(geo, tau))
    kw = dict(tau=tau, c_wale=0.5, nu_sgs_background=0.0005,
              inlet_turbulence=inlet_turb, wall_model=wall_model,
              sponge_blend=sponge_blend, use_temporal=False)
    fb, vb = _to_blocks(f0, geo.coords), _to_blocks(vel0, geo.coords)
    f, v = torch.from_numpy(fb), torch.from_numpy(vb)
    fj, vj = jnp.asarray(fb), jnp.asarray(vb)
    for t_seed in (77, 78):
        f, r, v = sc.stream_collide(f, v, 0.05, t_seed, static, **kw)
        fj, rj, vj = sc_jax.stream_collide(fj, vj, jnp.float32(0.05),
                                           jnp.int32(t_seed), static_j, **kw)
        for got, want in ((f, fj), (r, rj), (v, vj)):
            assert _max_diff(got, want) < 1e-5


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    """A 2-level sphere whose level 2 covers part of level 1 (parent
    fix-ups on its faces) and carries Bouzidi links, built by both
    packages, with random float32 states from one seed."""
    d = str(tmp_path_factory.mktemp("sphere2"))
    make_case_sphere(d, "1M", surface_resolution=10, num_levels=2, steps=4,
                     ramp_steps=2, wake_enabled=False, inlet_turbulence=0.02)
    cfg, cfg_j = load_case_config(d), load_case_config_jax(d)
    _, params, levels = builder.setup_case(cfg)
    _, params_j, levels_j = builder_jax.setup_case(cfg_j)
    _, statics = state.build_all(cfg, params, levels)
    _, statics_j = state_jax.build_all(cfg_j, params_j, levels_j)
    assert statics[1]["plan"]["parent_k"].shape[0] > 0
    assert statics[1]["bouzidi"] is not None
    rng = np.random.default_rng(11)
    arrays = []
    for g in levels:
        arrays.append({
            "f": (lat.W[:, None, None] * (1 + 0.03 * rng.standard_normal(
                (27, g.n_blocks, 512)))).astype(np.float32),
            "rho": (1 + 0.01 * rng.standard_normal((g.n_blocks, 512))).astype(np.float32),
            "vel": (0.02 * rng.standard_normal((3, g.n_blocks, 512))).astype(np.float32),
        })
    old = {k: (a * (1 + 0.01 * rng.standard_normal(a.shape))).astype(np.float32)
           for k, a in arrays[0].items()}
    return cfg, params, statics, cfg_j, params_j, statics_j, arrays, old


def _torch_state(a):
    return {k: torch.from_numpy(v.copy()) for k, v in a.items()}


def _jax_state(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


@pytest.mark.parametrize("temporal_weight", [0.0, 0.5])
def test_level2_step_with_parent_matches_jax(sphere2, temporal_weight):
    """A level-2 sub-step reading its parent's pre- and post-step states
    (trilinear corners, validity fall-back, temporal blend, f_neq
    rescale) through both packages: within 1e-5; the parent's tensors are
    left as they were."""
    cfg, params, statics, cfg_j, params_j, statics_j, arrays, old = sphere2
    parent, parent_old = _torch_state(arrays[0]), _torch_state(old)
    pv = _parent_view(parent, parent_old)
    pv_j = {k: jnp.asarray(v.numpy()) for k, v in pv.items()}
    kw = dict(tau=float(params.tau_levels[1]), c_wale=cfg.c_wale,
              nu_sgs_background=cfg.nu_sgs_background, inlet_turbulence=0.02,
              wall_model=True, sponge_blend=True, use_temporal=True,
              temporal_weight=temporal_weight)
    child = _torch_state(arrays[1])
    got = sc.stream_collide(child["f"], child["vel"], 0.03, 9, statics[1],
                            parent=pv, **kw)
    want = sc_jax.stream_collide(jnp.asarray(arrays[1]["f"]),
                                 jnp.asarray(arrays[1]["vel"]), jnp.float32(0.03),
                                 jnp.int32(9), statics_j[1], parent=pv_j, **kw)
    for g, w in zip(got, want):
        assert _max_diff(g, w) < 1e-5
    for key in ("f", "rho", "vel"):
        assert np.array_equal(parent[key].numpy(), arrays[0][key])
        assert np.array_equal(parent_old[key].numpy(), old[key])
    # the interpolated fix-ups alone, against JAX's
    vals = sc._parent_interp(statics[1]["plan"], pv, temporal_weight, True)
    vals_j = sc_jax._parent_interp(statics_j[1]["plan"], pv_j, None,
                                   temporal_weight, True)
    assert vals.shape[0] == statics[1]["plan"]["parent_k"].shape[0]
    assert _max_diff(vals, vals_j) < 1e-6


def test_apply_bouzidi_matches_jax(sphere2):
    """The Bouzidi links of level 2 on a random post-collision f: within
    1e-6, only the linked slots changed, and the input left intact."""
    _, _, statics, _, _, statics_j, arrays, _ = sphere2
    f = torch.from_numpy(arrays[1]["f"].copy())
    got = sc.apply_bouzidi(f, statics[1]["bouzidi"])
    want = sc_jax.apply_bouzidi(jnp.asarray(arrays[1]["f"]), statics_j[1]["bouzidi"])
    assert _max_diff(got, want) < 1e-6
    assert np.array_equal(f.numpy(), arrays[1]["f"])
    changed = np.nonzero((got != f).reshape(-1).numpy())[0]
    assert len(changed) > 0
    assert np.isin(changed, statics[1]["bouzidi"]["dst"].numpy()).all()


def test_coarse_steps_match_jax(sphere2):
    """Three coarse steps of the 2-level sphere (level 2 twice per coarse
    step at temporal weights 0 and 0.5, Bouzidi, inlet noise) through both
    packages' make_coarse_step: every level within 2e-5."""
    cfg, params, statics, cfg_j, params_j, statics_j, arrays, _ = sphere2
    step = make_coarse_step(cfg, params, statics)
    step_j = make_coarse_step_jax(cfg_j, params_j, statics_j)
    states = [_torch_state(a) for a in arrays]
    states_j = [_jax_state(a) for a in arrays]
    for t in (1, 2, 3):
        states = step(states, t)
        states_j = step_j(states_j, jnp.int32(t))
    for st, sj in zip(states, states_j):
        for key in ("f", "rho", "vel"):
            assert _max_diff(st[key], sj[key]) < 2e-5, key


def test_coarse_step_frees_previous_states(sphere2):
    """A coarse step keeps no reference to the states it replaced: with the
    garbage collector off, the previous step's tensors are freed as soon
    as the caller drops them (a reference cycle in the scheduler would hold
    every level's state of each step until a collection)."""
    cfg, params, statics, _, _, _, arrays, _ = sphere2
    step = make_coarse_step(cfg, params, statics)
    states = step([_torch_state(a) for a in arrays], 1)
    gone = [weakref.ref(st["f"]) for st in states]
    enabled = gc.isenabled()
    gc.disable()
    try:
        states = step(states, 2)
        assert all(r() is None for r in gone)
    finally:
        if enabled:
            gc.enable()


def _fixed_level(dims, shape, tau):
    return _dense_level(topo, builder, dims, np.zeros(shape, bool),
                        np.zeros(shape, np.float32),
                        np.full(shape, 100.0, np.float32), tau)


def test_equilibrium_is_fixed_point():
    """The rest equilibrium with u_inlet = 0 stays put on every boundary
    type (tests/test_stream_collide.py:143)."""
    geo = _fixed_level((2, 1, 1), (16, 8, 8), 0.6)
    static = state.build_level_static(geo, None, CaseConfig(), _stub_params(geo, 0.6))
    st = state.init_level_state(geo)
    f1, r1, v1 = sc.stream_collide(
        st["f"], st["vel"], 0.0, 0, static, tau=0.6, c_wale=0.5,
        nu_sgs_background=0.0, inlet_turbulence=0.0, wall_model=False,
        sponge_blend=True, use_temporal=False)
    assert torch.allclose(f1, st["f"], atol=1e-7)
    assert torch.allclose(r1, torch.ones_like(r1), atol=1e-6)
    assert float(v1.abs().max()) <= 1e-7


def test_mass_conservation_interior():
    """No obstacle, no sponge, no inflow: the total mass drifts by under
    1e-4 over five steps (tests/test_stream_collide.py:172)."""
    geo = _fixed_level((2, 2, 2), (16, 16, 16), 0.55)
    static = state.build_level_static(geo, None, CaseConfig(), _stub_params(geo, 0.55))
    f = torch.as_tensor(lat.W)[:, None, None] * torch.ones((27, 8, 512))
    f[:, 0, 300] *= 1.01
    v = torch.zeros((3, 8, 512))
    m0 = float(f.double().sum())
    for _ in range(5):
        f, r, v = sc.stream_collide(
            f, v, 0.0, 0, static, tau=0.55, c_wale=0.5, nu_sgs_background=0.0,
            inlet_turbulence=0.0, wall_model=False, sponge_blend=False,
            use_temporal=False)
    assert abs(float(f.double().sum()) - m0) / m0 < 1e-4


def test_blocks_layout_matches_patch_layout(tmp_path):
    """The single-level sphere of tests/test_layout_equivalence.py:40 on
    the port's two layouts from rest: both simulate the same dense grid, so
    f and vel agree within 5e-6 after 4 coarse steps."""
    make_case_sphere(
        str(tmp_path), "1M", surface_resolution=10, num_levels=1, steps=6,
        ramp_steps=3, output_freq=100, diag_freq=100, wake_enabled=False,
        boundary_method="bounce_back", wall_model=True, inlet_turbulence=0.02)
    cfg = load_case_config(str(tmp_path)).with_overrides(precision="float32")
    mesh, params, levels = builder.setup_case(cfg)
    patches = build_patches(cfg, mesh, params)
    dstat = build_patch_statics(cfg, patches)
    dstate = [init_patch_state(p) for p in patches]
    step_d = make_coarse_step_dense(cfg, params, patches, dstat)
    bstate, bstat = state.build_all(cfg, params, levels)
    step_b = make_coarse_step(cfg, params, bstat)
    for t in range(1, 5):
        dstate = step_d(dstate, t)
        bstate = step_b(bstate, t)
    X, Y, Z = patches[0].interior
    for key in ("f", "vel"):
        got = _to_dense(bstate[0][key].numpy(), levels[0].coords,
                        levels[0].dims)[..., :X, :Y, :Z]
        d = np.abs(got - dstate[0][key].numpy()).max()
        assert d < 5e-6, (key, d)

"""K4 (the flat-(y,z) step of an interface-free level) of the PyTorch port
against the JAX package, and against K1.

- K4's plain version (the CPU path of
  `open_ludwig_torch.ops.cuda_step.stream_collide_flat`) against
  `make_pallas_step_flat(interpret=True, alias_f=True)` on a (16, 6, 10)
  level (M = 128 > Y * Z = 60: the pad tail) and on a (16, 8, 16) level
  (Y * Z = 128), with inlet, outlet and mirror faces, an obstacle, the wall
  model, the sponge and inlet noise: float32 < 1e-5, bf16 g-storage < 2e-3
  (measured 8.9e-8 and 1.5e-5 on the stored values);
- K4's plain version against the port's `dense_stream_collide`: equal;
- at an x extent the TPU's flat gate refused (13 planes), the card's rule
  runs level 1 on K4, and K4 equals K1 there;
- a 2-level sphere with `flat_coarse: auto` (level 1, 40x40x40, runs K4)
  through the port and through the JAX package's Pallas path in interpret
  mode, 2 coarse steps, per level < 2e-5 (float32) and < 2e-3 (bf16);
- `convert` carries a JAX flat level's state and statics across, and a
  flat state back bit for bit;
- the wrapper's preallocated outputs (`out=`): the same values, written
  into and returned, and outputs of the wrong shape, dtype or aliasing the
  inputs refused.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu import solver_dense as sd_jax
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.ops.pallas_step import make_pallas_step_flat, prepare_pallas_statics
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import cuda_step, engine, storage
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops.cuda_step import stream_collide, stream_collide_flat

torch.set_num_threads(1)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
KW = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=0.02,
          wall_model=True, sponge_blend=True)


def _jax_level(interior, face_bc=DOMAIN, lo=(0, 3, 5), tau=0.53, fields=True):
    """A JAX level padded to the TPU tile; shape only (1-cell fields) unless
    `fields`."""
    X, Y, Z = interior
    padded = (X, -(-Y // 8) * 8, -(-Z // 128) * 128)
    sh = padded if fields else (1, 1, 1)
    return PatchLevel(1, 0.1, tau, lo, tuple(interior), padded, tuple(face_bc),
                      np.zeros(sh, bool), np.zeros(sh, np.float32),
                      np.full(sh, 100.0, np.float32))


def _port_static(tp):
    return {key: torch.as_tensor(getattr(tp, name)) for key, name in
            (("obstacle", "obstacle"), ("sponge", "sponge"),
             ("wall_dist", "wall_dist"))}


def _encode_np(f, store_bf16):
    """float32 f -> the JAX stored array (g = f - w in bf16)."""
    if not store_bf16:
        return jnp.asarray(f)
    w = lat.W.astype(np.float32).reshape((27,) + (1,) * (f.ndim - 1))
    return jnp.asarray(f - w).astype(jnp.bfloat16)


@contextlib.contextmanager
def _backend_as_tpu():
    """The JAX patch builder's flat gate asks jax.default_backend(); make it
    answer as on a TPU while the reference builds its levels."""
    real = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        yield
    finally:
        jax.default_backend = real


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("interior", [(16, 6, 10), (16, 8, 16)],
                         ids=["pad-tail", "M=YZ"])
def test_flat_plain_matches_pallas_flat(interior, store_bf16):
    rng = np.random.default_rng(7)
    X, Y, Z = interior
    jp = _jax_level(interior)
    jp.obstacle[5:8, 2:4, 3:6] = True
    jp.sponge[12:] = 0.3
    jp.wall_dist[4, 1, 2] = 1.0
    jp.wall_dist[9, 4, 7] = 2.0
    jp.flat_yz = True
    f0 = (lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32)
    v0 = (0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32)
    fj = _encode_np(convert.to_jax_layout(f0, jp, lat.W.astype(np.float32)),
                    store_bf16)
    vj = jnp.asarray(convert.to_jax_layout(v0, jp, 0.0))
    step = make_pallas_step_flat(jp, interpret=True, planes_per_step=8,
                                 alias_f=True, store_bf16=store_bf16, **KW)
    want = step(fj, vj, jnp.float32(0.04), jnp.int32(9),
                prepare_pallas_statics(jp))
    want = [convert.from_jax_layout(np.asarray(a).astype(np.float32), jp)
            for a in want]

    tp = convert.level_from_jax(jp)
    f_t = convert.to_tensor(convert.from_jax_layout(np.asarray(fj), jp))
    got = stream_collide_flat(f_t, torch.as_tensor(v0), 0.04, 9,
                              _port_static(tp), tp, **KW)
    assert got[0].dtype == f_t.dtype
    tol = 2e-3 if store_bf16 else 1e-5
    w = lat.W[:, None, None, None] if store_bf16 else 0.0
    df = np.abs(storage.decode_f(got[0]).numpy() - (want[0] + w)).max()
    dr = np.abs(got[1].numpy() - want[1]).max()
    dv = np.abs(got[2].numpy() - want[2]).max()
    assert df < tol and dr < tol and dv < tol, (df, dr, dv)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_flat_plain_equals_dense_stream_collide(store_bf16):
    """The flat shifts' wrapped values all land on face rows that the
    boundary masks overwrite: K4's plain version and K1's are equal."""
    rng = np.random.default_rng(11)
    X, Y, Z = 7, 5, 9
    tp = convert.level_from_jax(_jax_level((X, Y, Z)))
    tp.obstacle[2:4, 1:3, 3:5] = True
    tp.sponge[5:] = 0.2
    tp.wall_dist[1, 1, 2] = 1.5
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, "bfloat16")
    vel = torch.as_tensor((0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32))
    st = _port_static(tp)
    got = stream_collide_flat(f, vel, 0.035, 4, st, tp, **KW)
    want = stream_collide(f, vel, 0.035, 4, st, tp, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fd = storage.decode_f(f)
    plain = ds.stream_collide_flat_plain(fd, vel, 0.035, 4, st, tp, **KW)
    dense = ds.dense_stream_collide(fd, vel, 0.035, 4, st, tp, **KW)
    for a, b in zip(plain, dense):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ds.stream_collide_flat_plain(fd, vel, 0.035, 4, st, dataclasses.replace(
            tp, face_bc=(BC_INTERFACE,) + DOMAIN[1:]), **KW)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_flat_plain_equals_dense_at_an_x_extent_the_tpu_gate_refused(store_bf16):
    """A level 1 of 13 x planes, which no flat PX of the TPU's divides (its
    gate ran such a level on K1): the card's rule runs it on K4 below a
    child, and K4 equals K1 there, through the wrappers and their plain
    versions, with obstacle cells on the inlet and outlet planes."""
    rng = np.random.default_rng(13)
    X, Y, Z = 13, 6, 10
    tp = convert.level_from_jax(_jax_level((X, Y, Z)))
    tp.obstacle[0, 2:4, 3:5] = True
    tp.obstacle[X - 1, 1:3, 6:8] = True
    tp.sponge[9:] = 0.25
    tp.wall_dist[6, 3, 4] = 1.2
    child = dataclasses.replace(tp, level_id=2, face_bc=(BC_INTERFACE,) * 6)
    assert [e for e, _ in engine.card_engines([tp, child], None, lambda e: 0)] == \
        ["flat", "k1"]
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, "bfloat16")
    vel = torch.as_tensor((0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32))
    st = _port_static(tp)
    got = stream_collide_flat(f, vel, 0.041, 6, st, tp, **KW)
    want = stream_collide(f, vel, 0.041, 6, st, tp, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fd = storage.decode_f(f)
    plain = ds.stream_collide_flat_plain(fd, vel, 0.041, 6, st, tp, **KW)
    dense = ds.dense_stream_collide(fd, vel, 0.041, 6, st, tp, **KW)
    for a, b in zip(plain, dense):
        assert torch.equal(a, b)


def _sphere(tmp, **kw):
    make_case_sphere(tmp, "1M", **kw)
    cfg = load_case_config(tmp)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params


@pytest.fixture(scope="module")
def sphere_flat(tmp_path_factory):
    """2-level sphere, surface_resolution 8: level 1 is 40x40x40, whose x
    extent takes the flat PX of 8 (so both packages run it flat)."""
    cfg, mesh, params = _sphere(
        str(tmp_path_factory.mktemp("sphere_flat")), surface_resolution=8,
        num_levels=2, steps=3, ramp_steps=2, output_freq=100, diag_freq=100,
        inlet_turbulence=0.02)
    assert cfg.flat_coarse == "auto"
    with _backend_as_tpu():
        levels_j = build_patches_jax(cfg, mesh, params)
    levels_t = build_patches(cfg, mesh, params)
    assert [p.flat_yz for p in levels_j] == [True, False]
    return cfg, params, levels_j, levels_t


def _random_port_states(levels, precision, seed):
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


def _to_jax_states(states, levels_j, precision):
    out = []
    for s, p in zip(states, levels_j):
        a = convert.state_to_jax(s, p)
        dt = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
        out.append({"f": jnp.asarray(a["f"]).astype(dt),
                    "rho": jnp.asarray(a["rho"]), "vel": jnp.asarray(a["vel"])})
    return out


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_flat_coarse_sphere_matches_jax_pallas(sphere_flat, precision):
    """Two coarse steps from one random state: the port (level 1 on K4's
    plain version, level 2's pairs on K3's) against the JAX package's Pallas
    path in interpret mode (level 1 make_pallas_step_flat, level 2
    make_pallas_step_fused2), per level."""
    cfg, params, levels_j, levels_t = sphere_flat
    cfg = dataclasses.replace(cfg, precision=precision)
    statics_t = sd.build_patch_statics(cfg, levels_t)
    assert [s["engine"] for s in statics_t] == ["flat", "k1"]
    states_t = _random_port_states(levels_t, precision, 21)
    states_j = _to_jax_states(states_t, levels_j, precision)
    run_j = sd_jax.make_batch_runner_dense(
        cfg, params, levels_j, sd_jax.build_patch_statics(cfg, levels_j),
        use_pallas=True)
    assert run_j.pallas_levels == (True, True) and run_j.fused2
    states_j = run_j(states_j, np.int32(1), 2)
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t, statics_t, fuse2=True)
    assert run_t.fused2
    states_t = run_t(states_t, 1, 2)

    tol = 2e-3 if precision == "bfloat16" else 2e-5
    for li, (p, sj, st) in enumerate(zip(levels_j, states_j, states_t)):
        got = convert.state_to_numpy(st)
        for key in ("f", "rho", "vel"):
            want = convert.from_jax_layout(np.asarray(sj[key]).astype(np.float32), p)
            d = np.abs(got[key] - want).max()
            assert d < tol, (li, key, d)


def test_convert_flat_level_round_trip(sphere_flat):
    """A JAX flat level's bf16 state (pad tail at rest) crosses to the port
    and back bit for bit; its flat statics convert to the port's."""
    cfg, _, levels_j, levels_t = sphere_flat
    p = levels_j[0]
    rng = np.random.default_rng(3)
    st = sd_jax.init_patch_state(p, "bfloat16")
    M0 = p.flat_m0
    f = np.asarray(st["f"]).astype(np.float32)
    f[:, :, :M0] = 0.01 * rng.standard_normal((27, p.padded[0], M0))
    rho = np.asarray(st["rho"]).copy()
    rho[:, :M0] += 0.01 * rng.standard_normal((p.padded[0], M0)).astype(np.float32)
    vel = np.asarray(st["vel"]).copy()
    vel[:, :, :M0] = 0.02 * rng.standard_normal((3, p.padded[0], M0))
    st = {"f": jnp.asarray(f).astype(jnp.bfloat16), "rho": jnp.asarray(rho),
          "vel": jnp.asarray(vel)}
    port = convert.state_from_jax({k: np.asarray(v) for k, v in st.items()}, p)
    assert port["f"].shape == (27,) + tuple(p.interior)
    assert port["f"].dtype == torch.bfloat16
    back = convert.state_to_jax(port, p)
    assert back["f"].shape == (27, p.padded[0], p.flat_m)
    g0 = np.asarray(st["f"]).view(np.int16)
    g1 = np.asarray(jnp.asarray(back["f"]).astype(jnp.bfloat16)).view(np.int16)
    assert np.array_equal(g0, g1)
    for key in ("rho", "vel"):
        assert np.array_equal(back[key], np.asarray(st[key])), key
    statics_j = sd_jax.build_patch_statics(cfg, levels_j)
    statics_t = sd.build_patch_statics(cfg, levels_t)
    conv = convert.statics_from_jax(
        {k: np.asarray(v) for k, v in statics_j[0].items() if k != "bouzidi"},
        p, None)
    for key in ("obstacle", "sponge", "wall_dist"):
        assert torch.equal(conv[key], statics_t[0][key]), key


def test_kernel_log_names_k4(sphere_flat):
    cfg, _, _, levels_t = sphere_flat
    statics = sd.build_patch_statics(cfg, levels_t)
    lines = sd.kernel_log_lines(levels_t, statics, cfg.precision, "cpu", fuse2=True)
    assert "K4 stream_collide_flat plain torch (CPU)" in lines[0]
    assert "neither finest nor Bouzidi: K4" in lines[0]
    assert "K3 no: parent of level 2" in lines[0]
    assert "K1 stream_collide" in lines[1] and "K3 fused_pair" in lines[1]


def test_flat_step_rejects_interface_levels():
    tp = convert.level_from_jax(_jax_level((4, 3, 5), face_bc=(BC_INTERFACE,) + DOMAIN[1:]))
    f = torch.zeros((27, 4, 3, 5))
    cuda_step.reset_launches()
    with pytest.raises(ValueError, match="interface"):
        stream_collide_flat(f, torch.zeros((3, 4, 3, 5)), 0.04, 1,
                            _port_static(tp), tp, **KW)
    assert cuda_step.LAUNCHES["stream_collide_flat"] == 0


def _small_flat_inputs(store_bf16):
    rng = np.random.default_rng(13)
    X, Y, Z = 6, 5, 7
    tp = convert.level_from_jax(_jax_level((X, Y, Z)))
    tp.wall_dist[1, 1, 2] = 1.5
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, "bfloat16")
    vel = torch.as_tensor((0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32))
    return f, vel, _port_static(tp), tp


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_flat_step_out_returns_the_same_values(store_bf16):
    f, vel, st, tp = _small_flat_inputs(store_bf16)
    want = stream_collide_flat(f, vel, 0.035, 4, st, tp, **KW)
    out = (torch.full_like(f, 7.0), torch.full(tp.interior, 7.0), torch.full_like(vel, 7.0))
    got = stream_collide_flat(f, vel, 0.035, 4, st, tp, out=out, **KW)
    assert all(g is o for g, o in zip(got, out))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flat_step_out_refuses_wrong_outputs():
    f, vel, st, tp = _small_flat_inputs(True)
    good = (torch.empty_like(f), torch.empty(tp.interior), torch.empty_like(vel))
    bad = {
        "shape": (good[0], torch.empty(tp.interior[:2]), good[2]),
        "dtype": (torch.empty(f.shape), good[1], good[2]),
        "aliases": (f, good[1], good[2]),
    }
    for match, out in bad.items():
        with pytest.raises(ValueError, match=match):
            stream_collide_flat(f, vel, 0.035, 4, st, tp, out=out, **KW)


@pytest.mark.parametrize("resident", [1056, 924], ids=["8-per-SM", "7-per-SM"])
def test_flat_instantiation_by_size(resident):
    """K4's launch shape (`cuda_step.flat_instantiation`, the rule its C
    entry applies): the bench's 64x56x56 level in bf16 makes at most two
    waves of 132 SMs x 8 (or 7) blocks of 128 and takes 64 registers; the
    10.8M-cell 232x216x216 level makes more and takes 10 blocks a SM;
    float32 takes one shape at every size."""
    small = {"threads": 128, "min_blocks": 8}
    stream = {"threads": 128, "min_blocks": 10}
    l1, row = 64 * 56 * 56, 232 * 216 * 216
    assert cuda_step.flat_instantiation(l1, True, resident) == small
    assert cuda_step.flat_instantiation(row, True, resident) == stream
    assert cuda_step.flat_instantiation(2 * resident * 128, True, resident) == small
    assert cuda_step.flat_instantiation(2 * resident * 128 + 1, True, resident) == stream
    for n in (l1, row):
        assert cuda_step.flat_instantiation(n, False, resident) == small

"""The sharded forms of K1, K4 and K5 (one x slab of a level with its
neighbours' edge planes) in the PyTorch port, on the CPU.

- `parallel.patch_shard.slab_bounds` on even and uneven extents;
- the plain sharded K1 (interface faces of every kind on the slabs, x faces
  only on the slabs that hold them), K4 and K5 through their wrappers'
  CPU path at 2 and 3 slabs: the slabs joined are bit-equal to the
  unsharded plain step, float32 and bf16;
- the port's 2-slab K1 step against the JAX package's
  `_shard_map_pstep(make_pallas_step(p, shard_nx=2, interpret=True))` on
  two of its 8 virtual CPU devices, on the setup of
  tests/test_patch_pallas.py:561-600, float32 < 1e-5 and bf16 < 2e-3 in
  decoded f (the port's tolerances against the JAX step);
- the card's kernel rule on the bench sphere at 1, 2 and 3 slabs: K4, K1,
  K1 on each (the slab extents do not enter it);
- the port's sharded batch runner on 2 CPU slabs against the JAX
  package's `make_batch_runner_sharded(use_pallas=False)` on 2 virtual
  devices, a 2-level sphere, 2 coarse steps, 2e-5 / 2e-3 (~15 s each).
"""

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
from open_ludwig_tpu.ops.pallas_step import make_pallas_step, prepare_pallas_statics
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import checks, convert
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import cuda_step, storage
from open_ludwig_torch.parallel.patch_shard import make_x_mesh, slab_bounds

torch.set_num_threads(1)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
IFACE = (BC_INTERFACE,) * 6
MIXED_A = (BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE, BC_INTERFACE,
           BC_MIRROR_Z)
MIXED_B = (BC_INTERFACE, BC_OUTLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z,
           BC_INTERFACE)
KW = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=0.02,
          wall_model=True, sponge_blend=True)
STEPS = {"k1": cuda_step.stream_collide, "flat": cuda_step.stream_collide_flat,
         "inplace": cuda_step.stream_collide_inplace}


@pytest.mark.parametrize("X,n,want", [
    (10, 3, [0, 3, 6, 10]), (64, 3, [0, 21, 42, 64]), (8, 2, [0, 4, 8]),
    (5, 5, [0, 1, 2, 3, 4, 5]), (7, 1, [0, 7]),
])
def test_slab_bounds(X, n, want):
    b = slab_bounds(X, n)
    assert b == want
    sizes = np.diff(b)
    assert sizes.sum() == X and sizes.max() - sizes.min() <= 1


def test_slab_bounds_refuses_more_slabs_than_planes():
    with pytest.raises(ValueError):
        slab_bounds(3, 4)
    with pytest.raises(ValueError):
        slab_bounds(3, 0)


def _level(interior, face_bc, rng, lo=(6, 10, 4), tau=0.53):
    """A port level with an obstacle block, a sponge ramp and near-wall
    cells, whose fields reach into every slab."""
    X, Y, Z = interior
    obstacle = np.zeros(interior, bool)
    obstacle[X // 2 - 1:X // 2 + 1, Y // 3:Y // 3 + 2, Z // 3:Z // 3 + 3] = True
    sponge = np.zeros(interior, np.float32)
    sponge[-3:] = np.linspace(0.1, 0.6, 3, dtype=np.float32)[:, None, None]
    wall = np.full(interior, 100.0, np.float32)
    wall += (rng.random(interior) < 0.15) * (rng.random(interior) * 3.0 - 99.5)
    return PatchLevel(2, 0.05, tau, lo, tuple(interior), tuple(interior),
                      tuple(face_bc), obstacle, sponge, wall.astype(np.float32))


def _inputs(tp, rng, store_bf16):
    X, Y, Z = tp.interior
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, "bfloat16")
    vel = torch.as_tensor((0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32))
    planes = {}
    for fc in range(6):
        if tp.face_bc[fc] != BC_INTERFACE:
            continue
        t = [a for a in range(3) if a != fc // 2]
        pl = torch.as_tensor((lat.W[:, None, None] * (1 + 0.03 * rng.standard_normal(
            (1, 27, tp.interior[t[0]], tp.interior[t[1]])))).astype(np.float32))
        planes[fc] = (pl - torch.as_tensor(lat.W).view(27, 1, 1)).to(torch.bfloat16) \
            if store_bf16 else pl
    static = {k: torch.as_tensor(getattr(tp, name)) for k, name in (
        ("obstacle", "obstacle"), ("sponge", "sponge"), ("wall_dist", "wall_dist"))}
    return {"f": f, "vel": vel, "iface": planes}, static


def _run_slabs(kind, tp, inp, static, n):
    """The level's sub-step slab by slab (`checks.slab_inputs`: edges from
    the neighbours' planes), the slabs joined."""
    b = slab_bounds(tp.interior[0], n)
    outs = []
    for i in range(n):
        sl = checks.slab_inputs(tp, inp, static, b, i)
        ifk = {"iface": sl["iface"]} if kind == "k1" else {}
        outs.append(STEPS[kind](sl["f"], sl["vel"], 0.035, 7, sl["static"], tp,
                                edges=sl["edges"], x_off=sl["x_off"], **ifk, **KW))
    return [torch.cat([o[j] for o in outs], dim=1 if j != 1 else 0) for j in range(3)]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind,face_bc", [
    ("k1", IFACE), ("k1", MIXED_A), ("k1", MIXED_B), ("flat", DOMAIN),
    ("inplace", DOMAIN),
], ids=["k1-iface", "k1-inlet-mix", "k1-outlet-mix", "flat", "inplace"])
def test_plain_slabs_equal_unsharded(kind, face_bc, n, store_bf16):
    """Slab by slab (uneven at 3: 10 planes) equals one device's step bit
    for bit: the edge planes supply exactly what the whole-level pull
    reads, and the masks sit at the same global cells."""
    rng = np.random.default_rng(7 + n)
    tp = _level((10, 6, 9), face_bc, rng)
    inp, static = _inputs(tp, rng, store_bf16)
    got = _run_slabs(kind, tp, inp, static, n)
    ifk = ({"iface": checks.sub_step_planes(inp["iface"], 0)} if kind == "k1" else {})
    want = STEPS[kind](inp["f"].clone(), inp["vel"], 0.035, 7, static, tp, **ifk, **KW)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_slab_wrappers_check_their_inputs():
    rng = np.random.default_rng(3)
    tp = _level((10, 6, 9), IFACE, rng)
    inp, static = _inputs(tp, rng, False)
    sl = checks.slab_inputs(tp, inp, static, slab_bounds(10, 2), 1)
    fe, ve = sl["edges"]
    args = (sl["f"], sl["vel"], 0.03, 1, sl["static"], tp)
    with pytest.raises(ValueError):  # an x slab needs its edges
        cuda_step.stream_collide(*args, iface=sl["iface"], **KW)
    with pytest.raises(ValueError):  # edges of the wrong dtype
        cuda_step.stream_collide(*args, iface=sl["iface"], edges=(fe.double(), ve),
                                 x_off=5, **KW)
    with pytest.raises(ValueError):  # the slab reaches past the level
        cuda_step.stream_collide(*args, iface=sl["iface"], edges=(fe, ve), x_off=6,
                                 **KW)
    whole = {fc: pl[0] for fc, pl in inp["iface"].items()}
    with pytest.raises(ValueError):  # the y/z planes must be the slab's
        cuda_step.stream_collide(*args, iface=whole, edges=(fe, ve), x_off=5, **KW)


def _jax_patch(interior, tau):
    X, Y, Z = interior
    padded = (X, -(-Y // 8) * 8, -(-Z // 128) * 128)
    return PatchLevel(1, 0.1, tau, (0, 0, 0), interior, padded, DOMAIN,
                      np.zeros(padded, bool), np.zeros(padded, np.float32),
                      np.full(padded, 100.0, np.float32))


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_two_slabs_match_jax_shard_map_step(store_bf16):
    """The port's 2-slab K1 step (plain) against the JAX package's sharded
    Pallas step under shard_map on 2 virtual devices, one sub-step."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n_dev = 2
    assert len(jax.devices()) >= n_dev
    rng = np.random.default_rng(1234)
    X, Y, Z = 8, 8, 120
    p = _jax_patch((X, Y, Z), tau=0.55)
    p.obstacle[3:5, 3:5, 50:56] = True
    jkw = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=0.01,
               wall_model=True, sponge_blend=True, interpret=True,
               store_bf16=store_bf16)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("x",))
    st3d = prepare_pallas_statics(p)
    # f around rest: g = f - w in bf16 storage, f itself in float32
    g0 = (lat.W[:, None, None, None] * 0.03 * rng.standard_normal(
        (27,) + p.padded)).astype(np.float32)
    f0 = g0 if store_bf16 else g0 + lat.W[:, None, None, None].astype(np.float32)
    v0 = (0.02 * rng.standard_normal((3,) + p.padded)).astype(np.float32)
    stepN = sd_jax._shard_map_pstep(
        make_pallas_step(p, shard_nx=n_dev, **jkw), p, mesh)
    xsh = NamedSharding(mesh, P(None, "x"))
    st3d_sh = dict(st3d)
    for k in ("obstacle_u8", "sponge3d", "wall3d"):
        st3d_sh[k] = jax.device_put(st3d[k], NamedSharding(mesh, P("x")))
    dt = jnp.bfloat16 if store_bf16 else jnp.float32
    fB, rB, vB = stepN(jax.device_put(jnp.asarray(f0, dt), xsh),
                       jax.device_put(jnp.asarray(v0), xsh), 0.02, 0, st3d_sh)

    tp = convert.level_from_jax(p)
    f_t = torch.as_tensor(np.ascontiguousarray(f0[:, :X, :Y, :Z]))
    if store_bf16:
        f_t = f_t.to(torch.bfloat16)
    inp = {"f": f_t, "vel": torch.as_tensor(np.ascontiguousarray(v0[:, :X, :Y, :Z])),
           "iface": {}}
    static = {k: torch.as_tensor(getattr(tp, name)) for k, name in (
        ("obstacle", "obstacle"), ("sponge", "sponge"), ("wall_dist", "wall_dist"))}
    b = slab_bounds(X, n_dev)
    outs = []
    for i in range(n_dev):
        sl = checks.slab_inputs(tp, inp, static, b, i)
        outs.append(cuda_step.stream_collide(
            sl["f"], sl["vel"], 0.02, 0, sl["static"], tp, edges=sl["edges"],
            x_off=sl["x_off"], c_wale=0.5, nu_sgs_background=5e-4,
            inlet_turbulence=0.01, wall_model=True, sponge_blend=True))
    f_p, r_p, v_p = (torch.cat([o[j] for o in outs], dim=1 if j != 1 else 0)
                     for j in range(3))

    def dec(a):
        a = np.asarray(a, np.float32)
        return a + lat.W[:, None, None, None] if store_bf16 else a

    tol = 2e-3 if store_bf16 else 1e-5
    fj = dec(np.asarray(fB.astype(jnp.float32))[:, :X, :Y, :Z])
    assert np.abs(storage.decode_f(f_p).numpy() - fj).max() < tol
    assert np.abs(r_p.numpy() - np.asarray(rB)[:X, :Y, :Z]).max() < tol
    assert np.abs(v_p.numpy() - np.asarray(vB)[:, :X, :Y, :Z]).max() < tol


# ---- the kernel choice on slabs ----

@pytest.mark.parametrize("n", [1, 2, 3])
def test_engine_on_slabs_of_bench_sphere(tmp_path, n):
    """The bench sphere (N=25, 3 levels + wake, bf16) on 1, 2 and 3 slabs:
    K4, K1, K1 on each.  The TPU's flat gate ran level 1 on K1 on 3 slabs
    (its 64 planes padded to 66, 22 a slab, which no flat PX divides); the
    card's rule reads no slab extent."""
    cfg, _, _, levels = checks.bench_case(str(tmp_path), steps=2, ramp_steps=1)
    mesh = make_x_mesh(n, "cpu") if n > 1 else None
    statics = sd.build_patch_statics(cfg, levels, "cpu", x_mesh=mesh)
    assert [st["engine"] for st in statics] == ["flat", "k1", "k1"]
    if mesh is not None:
        assert [st["bounds"] for st in statics] == [
            slab_bounds(p.interior[0], n) for p in levels]


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sharded_runner_matches_jax_sharded_runner(tmp_path, precision):
    """A 2-level sphere (surface_resolution 8, Bouzidi, inlet noise) on 2
    slabs: the port's `make_batch_runner_dense(x_mesh=)` on CPU slabs against the
    JAX package's (`parallel.patch_shard.make_batch_runner_sharded`, XLA
    path, 2 of its 8 virtual devices), 2 coarse steps from one random
    state, every level within 2e-5 (float32) and 2e-3 (bf16, stored g)."""
    from jax.sharding import Mesh

    from open_ludwig_tpu import solver_dense as sdj
    from open_ludwig_tpu.ops import storage as storage_jax
    from open_ludwig_tpu.parallel import patch_shard as psj

    from open_ludwig_torch.parallel import patch_shard as ps

    make_case_sphere(str(tmp_path), "1M", surface_resolution=8, num_levels=2,
                     steps=2, ramp_steps=2, output_freq=100, diag_freq=100,
                     inlet_turbulence=0.02, precision=precision)
    cfg = dataclasses.replace(load_case_config(str(tmp_path)), devices=2)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels_j = build_patches_jax(cfg, mesh, params)
    levels_t = build_patches(cfg, mesh, params)
    jmesh = Mesh(np.array(jax.devices()[:2]), axis_names=("x",))
    rng = np.random.default_rng(21)
    states_j = []
    for p in levels_j:
        f = (lat.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
            (27,) + p.padded))).astype(np.float32)
        states_j.append({
            "f": storage_jax.encode_f(jnp.asarray(f), precision),
            "rho": jnp.asarray((1 + 0.01 * rng.standard_normal(p.padded))
                               .astype(np.float32)),
            "vel": jnp.asarray((0.02 * rng.standard_normal((3,) + p.padded))
                               .astype(np.float32))})
    states_t = [convert.state_from_jax({k: np.asarray(v) for k, v in s.items()}, p)
                for s, p in zip(states_j, levels_j)]
    statics_j = psj.shard_statics(sdj.build_patch_statics(cfg, levels_j), levels_j,
                                  jmesh)
    run_j = psj.make_batch_runner_sharded(cfg, params, levels_j, statics_j, jmesh,
                                          use_pallas=False)
    out_j = run_j(psj.shard_states(states_j, jmesh), np.int32(1), 2)
    xm = ps.make_x_mesh(2, "cpu")
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t, sd.build_patch_statics(
        cfg, levels_t, x_mesh=xm), x_mesh=xm)
    out_t = ps.gather_states(run_t(ps.shard_states(states_t, xm), 1, 2), "cpu")
    tol = 2e-3 if precision == "bfloat16" else 2e-5
    for li, (p, sj, st) in enumerate(zip(levels_j, out_j, out_t)):
        want = {key: convert.trim(np.asarray(sj[key]).astype(np.float32), p.interior)
                for key in ("f", "rho", "vel")}
        got = convert.state_to_numpy(st)
        for key in want:
            d = np.abs(got[key] - want[key]).max()
            assert d < tol, (li, key, d)

"""K1 (stream-collide) of the PyTorch port against the JAX package.

Same inputs, made from a numpy seed, go through the JAX functions and the
port: hash noise bit-exact; the plain sub-step (the CPU path of
`open_ludwig_torch.ops.cuda_step.stream_collide`) against the XLA
`dense_stream_collide` (< 1e-5 in float32, < 2e-3 on bf16 g-storage) and
against the Pallas kernel in interpret mode; the endpoint path's ghost
planes against `interface_from_endpoints` (< 2e-6).  The port's steps read
the planes pre-shifted (27, A, B) in the level's storage type: the raw
(27, A+2, B+2) float32 planes the JAX XLA step reads go through
`dense_step.shift_planes` (bf16 g-space on bf16 levels, as the reference's
g-native Pallas step reads them), which `test_shift_planes_equal_raw_reads`
holds to the raw reads bit for bit.  The CUDA kernel against its plain
version at the bench case's shapes runs on the card only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig_tpu.ops import collide_math as cm_jax
from open_ludwig_tpu.ops import dense_step as ds_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.ops.pallas_step import (
    make_pallas_step, prep_iface_pallas, prepare_pallas_statics,
)

from open_ludwig_torch import convert
from open_ludwig_torch.ops import collide_math as cm
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops.cuda_step import stream_collide

torch.set_num_threads(1)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
IFACE = (BC_INTERFACE,) * 6
MIXED_A = (BC_INTERFACE, BC_OUTLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE,
           BC_INTERFACE)
MIXED_B = (BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE, BC_MIRROR_Z,
           BC_INTERFACE)


def level_pair(interior, face_bc, rng, lo=(10, 12, 14), tau=0.53):
    """(JAX level padded to the TPU tile, port level unpadded) sharing an
    obstacle block, a sponge ramp and a near-wall distance."""
    X, Y, Z = interior
    padded = (X, -(-Y // 8) * 8, -(-Z // 128) * 128)
    obstacle = np.zeros(interior, bool)
    obstacle[X // 3:X // 3 + 2, Y // 3:Y // 3 + 2, Z // 3:Z // 3 + 3] = True
    sponge = np.zeros(interior, np.float32)
    sponge[-3:] = np.linspace(0.1, 0.6, 3, dtype=np.float32)[:, None, None]
    wall = np.full(interior, 100.0, np.float32)
    wall[X // 3 - 1, Y // 3, Z // 3] = 1.2
    wall += (rng.random(interior) < 0.1) * (rng.random(interior) * 3.0 - 97.0)
    wall = wall.astype(np.float32)
    jp = PatchLevel(
        2, 0.05, tau, lo, tuple(interior), padded, tuple(face_bc),
        convert.pad(obstacle, padded, True),
        convert.pad(sponge, padded, np.float32(0.0)),
        convert.pad(wall, padded, np.float32(100.0)),
    )
    tp = dataclasses.replace(jp, padded=tuple(interior), obstacle=obstacle,
                             sponge=sponge, wall_dist=wall)
    return jp, tp


def random_inputs(jp, rng):
    f0 = (lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + jp.padded))).astype(np.float32)
    v0 = (0.02 * rng.standard_normal((3,) + jp.padded)).astype(np.float32)
    planes = {}
    for fc in range(6):
        if jp.face_bc[fc] != BC_INTERFACE:
            continue
        t = [a for a in range(3) if a != fc // 2]
        A, B = jp.padded[t[0]], jp.padded[t[1]]
        planes[fc] = (lat.W[:, None, None] * (1 + 0.03 * rng.standard_normal(
            (27, A + 2, B + 2)))).astype(np.float32)
    return f0, v0, planes


def jax_static(jp):
    return {
        "obstacle": jnp.asarray(jp.obstacle.reshape(-1)),
        "sponge": jnp.asarray(jp.sponge.reshape(-1)),
        "wall_dist": jnp.asarray(jp.wall_dist.reshape(-1)),
        "bouzidi": None,
    }


def port_static(tp):
    return {
        "obstacle": torch.as_tensor(tp.obstacle),
        "sponge": torch.as_tensor(tp.sponge),
        "wall_dist": torch.as_tensor(tp.wall_dist),
    }


def raw_planes(planes, tp):
    """The JAX test planes over the port level's extents: (27, A+2, B+2)."""
    out = {}
    for fc, pl in planes.items():
        t = [a for a in range(3) if a != fc // 2]
        A, B = tp.interior[t[0]], tp.interior[t[1]]
        out[fc] = torch.as_tensor(np.ascontiguousarray(pl[:, :A + 2, :B + 2]))
    return out


def port_planes(planes, tp, store_bf16=False):
    """The planes as the port's steps read them: pre-shifted (27, A, B) in
    the storage type (bf16 g-space on bf16 levels)."""
    return ds.shift_planes(raw_planes(planes, tp), tp, store_bf16,
                           torch.bfloat16 if store_bf16 else torch.float32)


def test_hash_noise_bit_exact():
    rng = np.random.default_rng(5)
    gy = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    gz = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    gy[:4] = [0, 1, (1 << 20) - 1, 12345]
    for seed in (0, 7, 123456, 999998, 999999):
        want = np.asarray(cm_jax.hash_noise(jnp.asarray(gy), jnp.asarray(gz),
                                            jnp.int32(seed)))
        got = cm.hash_noise(torch.as_tensor(gy), torch.as_tensor(gz), seed).numpy()
        assert np.array_equal(want, got), seed


KW = dict(c_wale=0.5, nu_sgs_background=5e-4)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("faces", [DOMAIN, IFACE, MIXED_A, MIXED_B],
                         ids=["domain", "iface", "mixedA", "mixedB"])
@pytest.mark.parametrize("wall_model,sponge_blend,inlet_turb",
                         [(False, False, 0.0), (True, True, 0.05)],
                         ids=["plain", "wall-sponge-noise"])
def test_stream_collide_matches_jax_dense(wall_model, sponge_blend, inlet_turb,
                                          faces, store_bf16):
    rng = np.random.default_rng(11)
    jp, tp = level_pair((12, 10, 9), faces, rng)
    f0, v0, planes = random_inputs(jp, rng)
    kw = dict(KW, inlet_turbulence=inlet_turb, wall_model=wall_model,
              sponge_blend=sponge_blend)
    fj = jnp.asarray(f0)
    if store_bf16:
        g = storage_jax.encode_f(fj, "bfloat16")
        fj = storage_jax.decode_f(g)
    f_ref, r_ref, v_ref = ds_jax.dense_stream_collide(
        fj, jnp.asarray(v0), jnp.float32(0.04), jnp.int32(7), jax_static(jp), jp,
        iface={fc: jnp.asarray(p) for fc, p in planes.items()}, **kw)

    f_in = (convert.to_tensor(convert.trim(np.asarray(g), tp.interior))
            if store_bf16 else torch.as_tensor(convert.trim(f0, tp.interior)))
    f_out, r_out, v_out = stream_collide(
        f_in.contiguous(), torch.as_tensor(convert.trim(v0, tp.interior)).contiguous(),
        0.04, 7, port_static(tp), tp, iface=port_planes(planes, tp, store_bf16), **kw)
    assert f_out.dtype == f_in.dtype
    tol = 2e-3 if store_bf16 else 1e-5
    got = ds.decode_f(f_out).numpy()
    for name, a, b in (("f", got, f_ref), ("rho", r_out.numpy(), r_ref),
                       ("vel", v_out.numpy(), v_ref)):
        d = np.abs(a - convert.trim(np.asarray(b), tp.interior)).max()
        assert d < tol, (name, d)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_stream_collide_matches_pallas_interpret(store_bf16):
    """The 8x8x120 box of test_patch_pallas.py (f32, domain faces) and its
    g-native bf16 twin with interface faces, against make_pallas_step in
    interpret mode; on bf16 both read the same bf16 g-space planes (the
    reference's main path hands its g-native step bf16 planes)."""
    rng = np.random.default_rng(1234)
    faces = MIXED_A if store_bf16 else DOMAIN
    jp, tp = level_pair((8, 8, 120), faces, rng)
    f0, v0, planes = random_inputs(jp, rng)
    kw = dict(KW, inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
    pstep = make_pallas_step(jp, interpret=True, store_bf16=store_bf16, **kw)
    f_in = storage_jax.encode_f(jnp.asarray(f0), "bfloat16") if store_bf16 \
        else jnp.asarray(f0)
    iface_j = None
    if planes:
        iface_j = prep_iface_pallas({fc: jnp.asarray(p) for fc, p in planes.items()},
                                    jp, g_shifted=store_bf16)
        iface_j = {fc: v.astype(jnp.bfloat16 if store_bf16 else jnp.float32)
                   for fc, v in iface_j.items()}
    f_pl, r_pl, v_pl = pstep(
        f_in, jnp.asarray(v0), jnp.float32(0.04), jnp.int32(9),
        prepare_pallas_statics(jp), iface_j)
    f_pl = storage_jax.decode_f(f_pl)

    f_t = convert.to_tensor(convert.trim(np.asarray(f_in), tp.interior))
    f_out, r_out, v_out = stream_collide(
        f_t, torch.as_tensor(convert.trim(v0, tp.interior)).contiguous(), 0.04, 9,
        port_static(tp), tp, iface=port_planes(planes, tp, store_bf16), **kw)
    tol = 2e-3 if store_bf16 else 1e-5
    d = np.abs(ds.decode_f(f_out).numpy()
               - convert.trim(np.asarray(f_pl), tp.interior)).max()
    assert d < tol, d
    dr = np.abs(r_out.numpy() - convert.trim(np.asarray(r_pl), tp.interior)).max()
    assert dr < tol, dr


@pytest.mark.parametrize("faces", [IFACE, MIXED_B], ids=["iface", "mixedB"])
def test_shift_planes_equal_raw_reads(faces):
    """float32: shift_planes(raw) holds, per face and direction k, the raw
    plane's window at transverse offset (1 - c_t), which the raw-plane step
    read (the JAX XLA step's read, dense_step.py:296-305 before the planes
    were pre-shifted), bit for bit; and the plain step over it equals, bit
    for bit, the plain step over the same planes pre-shifted by the JAX
    package's own `_shift_planes` (grouped slices and concatenations)."""
    rng = np.random.default_rng(13)
    jp, tp = level_pair((7, 6, 5), faces, rng)
    f0, v0, planes = random_inputs(jp, rng)
    raw = raw_planes(planes, tp)
    got = ds.shift_planes(raw, tp, False, torch.float32)
    theirs = {}
    for fc, pl in raw.items():
        ax = fc // 2
        t = [a for a in range(3) if a != ax]
        A, B = tp.interior[t[0]], tp.interior[t[1]]
        assert got[fc].shape == (27, A, B) and got[fc].is_contiguous()
        for k in range(27):
            c = (lat.C_X[k], lat.C_Y[k], lat.C_Z[k])
            s0, s1 = 1 - int(c[t[0]]), 1 - int(c[t[1]])
            assert torch.equal(got[fc][k], pl[k, s0:s0 + A, s1:s1 + B]), (fc, k)
        theirs[fc] = torch.as_tensor(np.array(ds_jax._shift_planes(
            jnp.asarray(pl.numpy()), ax, A, B)))
    kw = dict(KW, inlet_turbulence=0.05, wall_model=True, sponge_blend=True)
    f = torch.as_tensor(convert.trim(f0, tp.interior)).contiguous()
    v = torch.as_tensor(convert.trim(v0, tp.interior)).contiguous()
    a = stream_collide(f, v, 0.04, 5, port_static(tp), tp, iface=got, **kw)
    b = stream_collide(f, v, 0.04, 5, port_static(tp), tp, iface=theirs, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("parent_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_temporal", [True, False])
@pytest.mark.parametrize("parent_lo", [(0, 0, 0), (6, 4, 2)])
def test_ghost_planes_match_jax(parent_lo, use_temporal, parent_dtype):
    """Endpoint slabs -> temporal blend -> trilinear upsample -> feq + f_neq
    rescale, per interface face, over the port's (interior) plane extent."""
    rng = np.random.default_rng(3)
    parent = PatchLevel(1, 0.1, 0.58, parent_lo, (20, 16, 16), (20, 16, 24),
                        (BC_INLET,) * 6, None, None, None)
    child = PatchLevel(2, 0.05, 0.54,
                       (2 * parent_lo[0] + 10, 2 * parent_lo[1] + 8,
                        2 * parent_lo[2] + 8),
                       (14, 12, 12), (14, 16, 16), IFACE, None, None, None)
    parent_t = dataclasses.replace(parent, padded=parent.interior)
    child_t = dataclasses.replace(child, padded=child.interior)

    def rand_state():
        f = (lat.W[:, None, None, None] * (1.0 + 0.05 * rng.standard_normal(
            (27,) + parent.padded))).astype(np.float32)
        fj = storage_jax.encode_f(jnp.asarray(f), parent_dtype)
        return {
            "f": fj,
            "rho": jnp.asarray(1.0 + 0.02 * rng.standard_normal(parent.padded),
                               jnp.float32),
            "vel": jnp.asarray(0.03 * rng.standard_normal((3,) + parent.padded),
                               jnp.float32),
        }

    st_old, st_new = rand_state(), rand_state()
    if use_temporal:
        ep_old, ep_new = ds_jax.interface_endpoints_pair(child, parent, st_old, st_new)
        tp_old = convert.state_from_jax(
            {k: np.asarray(v) for k, v in st_old.items()}, parent_t)
        tp_new = convert.state_from_jax(
            {k: np.asarray(v) for k, v in st_new.items()}, parent_t)
        eo, en = ds.interface_endpoints_pair(child_t, parent_t, tp_old, tp_new)
    else:
        ep_old, ep_new = None, ds_jax.interface_endpoints(child, parent, st_new)
        tp_new = convert.state_from_jax(
            {k: np.asarray(v) for k, v in st_new.items()}, parent_t)
        eo, en = None, ds.interface_endpoints(child_t, parent_t, tp_new)
    for tw in (0.0, 0.5):
        want = ds_jax.interface_from_endpoints(ep_new, ep_old, child, parent, tw,
                                               use_temporal)
        got = ds.interface_from_endpoints(en, eo, child_t, parent_t, tw, use_temporal)
        assert set(got) == set(want)
        for face, pl in got.items():
            t = [a for a in range(3) if a != face // 2]
            A, B = child.interior[t[0]], child.interior[t[1]]
            assert pl.shape == (27, A + 2, B + 2)
            d = np.abs(pl.numpy() - np.asarray(want[face])[:, :A + 2, :B + 2]).max()
            assert d < 2e-6, (face, tw, d)


@pytest.mark.parametrize("bad", ["f_shape", "f_dtype", "vel_noncontig",
                                 "plane_shape", "plane_missing", "plane_raw",
                                 "plane_dtype", "device"])
def test_stream_collide_rejects_bad_inputs(bad):
    """The wrapper validates what it would hand the kernel as raw pointers;
    the planes must be pre-shifted (27, A, B) in f's storage type (the raw
    (27, A+2, B+2) form, and bf16 planes on a float32 level, are refused)."""
    rng = np.random.default_rng(2)
    jp, tp = level_pair((6, 5, 4), MIXED_A, rng)
    f0, v0, planes = random_inputs(jp, rng)
    f = torch.as_tensor(convert.trim(f0, tp.interior)).contiguous()
    vel = torch.as_tensor(convert.trim(v0, tp.interior)).contiguous()
    iface = port_planes(planes, tp)
    if bad == "f_shape":
        f = f[:, :-1].contiguous()
    elif bad == "f_dtype":
        f = f.double()
    elif bad == "vel_noncontig":
        vel = vel.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "plane_shape":
        iface[0] = iface[0][:, :-1].contiguous()
    elif bad == "plane_missing":
        del iface[2]
    elif bad == "plane_raw":
        iface = raw_planes(planes, tp)
    elif bad == "plane_dtype":
        iface[0] = iface[0].to(torch.bfloat16)
    else:
        f = f.to("meta")
    with pytest.raises(ValueError):
        stream_collide(f, vel, 0.04, 1, port_static(tp), tp, iface=iface,
                       **KW, inlet_turbulence=0.0, wall_model=False,
                       sponge_blend=False)

"""The ghost planes of the port's main path against the JAX package.

The port builds each child level's interface ghost planes as the
reference's Pallas path does: a static plan of small matrices per child
level (`build_iface_mm_plan`), the parent's endpoint slabs extracted once
per parent step and carried to the next (`extract_endpoint_slabs`), and one
contraction + elementwise tail per axis group (`interface_planes_pair_mm`),
giving pre-shifted (nw, 27, A, B) planes per face in the child's storage
type.  Same inputs, made from a numpy seed:

- (a) the port's plan equals JAX's `build_iface_mm_plan` exactly, JAX's
  built on a parent with padded = interior stored flat-(y, z) (alignment 1
  on every axis, as the port's levels have);
- (b) the port's planes against JAX `interface_planes_pair_mm` on a padded
  JAX parent (its y/z planes transposed to (27, A, B), all trimmed to the
  child's interior): < 2e-6 from float32 states, < 2e-3 from bf16 states
  (the reference's bf16 tolerance: its slab math runs in bf16, the port's
  in float32);
- (c) the port's planes against its own endpoint path +
  `dense_step.shift_planes`: < 2e-6, and the bf16 planes the float32 ones
  cast;
- (d) slabs carried over three parent steps equal freshly extracted ones
  bit for bit, and the planes and states built from them equal the
  unseeded path's;
- (e) the contraction's largest tensor stays under its stated bound (4/3
  of the output planes), far below the outer product of UA3 and UB3 that
  the reference's three-operand einsum specs, contracted left to right,
  would form;
- the main path never calls the endpoint path (patched to raise), and a
  3-level sphere whose finest level's parent has lo != 0 (the round-3
  regression of tests/test_dense.py:176-178) matches the JAX package's
  Pallas runner in interpret mode for two coarse steps, per level < 2e-5
  (float32) and < 2e-3 (bf16).
"""

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu import solver_dense as sd_jax
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import BC_INLET, BC_INTERFACE, PatchLevel
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.ops import dense_step as ds_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops import storage

torch.set_num_threads(2)

IFACE = (BC_INTERFACE,) * 6
# (parent lo, child lo, child interior) on a (20, 16, 16) parent: the child
# inside the parent, the same with the parent offset (a level 3+ parent),
# and a child whose slabs reach past the parent's edges (the clamp)
GEOMS = {
    "lo0": ((0, 0, 0), (10, 8, 8), (14, 12, 12)),
    "lo642": ((6, 4, 2), (22, 16, 12), (14, 12, 12)),
    "edge": ((0, 0, 0), (2, 2, 2), (16, 14, 30)),
}


def _levels(geom, child_padded=None, parent_padded=None, flat=False):
    """(JAX parent, JAX child, port parent, port child) of a geometry."""
    parent_lo, child_lo, child_in = GEOMS[geom]
    parent = PatchLevel(1, 0.1, 0.58, parent_lo, (20, 16, 16),
                        parent_padded or (20, 16, 16), (BC_INLET,) * 6,
                        None, None, None, flat_yz=flat)
    child = PatchLevel(2, 0.05, 0.54, child_lo, child_in, child_padded or child_in,
                       IFACE, None, None, None)
    return (parent, child, dataclasses.replace(parent, padded=parent.interior),
            dataclasses.replace(child, padded=child.interior))


def _jax_state(rng, shape, dtype):
    f = (lat.W[:, None, None, None] * (1.0 + 0.05 * rng.standard_normal(
        (27,) + shape))).astype(np.float32)
    return {
        "f": storage_jax.encode_f(jnp.asarray(f), dtype),
        "rho": jnp.asarray(1.0 + 0.02 * rng.standard_normal(shape), jnp.float32),
        "vel": jnp.asarray(0.03 * rng.standard_normal((3,) + shape), jnp.float32),
    }


def _port_state(rng, shape, dtype):
    f = (lat.W[:, None, None, None] * (1.0 + 0.05 * rng.standard_normal(
        (27,) + shape))).astype(np.float32)
    return {
        "f": storage.encode_f(torch.as_tensor(f), dtype),
        "rho": torch.as_tensor((1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)),
        "vel": torch.as_tensor((0.03 * rng.standard_normal((3,) + shape)).astype(np.float32)),
    }


def _port_planes(child, parent, old, new, use_temporal, g_shifted, out_dtype):
    plan = ds.iface_mm_plan_to(ds.build_iface_mm_plan(child, parent), "cpu")
    slabs_old = ds.extract_endpoint_slabs(plan, old) if use_temporal else None
    return ds.interface_planes_pair_mm(plan, child, parent, slabs_old,
                                       ds.extract_endpoint_slabs(plan, new),
                                       use_temporal, g_shifted, out_dtype)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_plan_equals_jax_flat_parent_plan(geom):
    """(a) The port's plan is JAX's for a parent of alignment 1, exactly."""
    parent, child, parent_t, child_t = _levels(geom, flat=True)
    want = ds_jax.build_iface_mm_plan(child, parent)
    got = ds.build_iface_mm_plan(child_t, parent_t)
    assert want["flat"] == parent.interior[1:]
    assert len(got["groups"]) == len(want["groups"]) == 3
    for g, w in zip(got["groups"], want["groups"]):
        for key in ("axis", "faces", "A", "B", "starts", "sizes", "lerp_idx"):
            assert g[key] == w[key], (key, g[key], w[key])
        for key in ("UA3", "UB3", "UN2"):
            assert g[key].dtype == np.float32
            assert np.array_equal(g[key], np.asarray(w[key])), key


def test_plan_of_a_level_without_interface_is_none():
    parent, child, parent_t, child_t = _levels("lo0")
    assert ds.build_iface_mm_plan(dataclasses.replace(child_t, face_bc=(BC_INLET,) * 6),
                                  parent_t) is None
    assert ds.iface_mm_plan_to(None, "cpu") is None


@pytest.mark.parametrize("parent_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_shifted", [True, False], ids=["g", "f"])
@pytest.mark.parametrize("use_temporal", [True, False], ids=["temporal", "frozen"])
@pytest.mark.parametrize("geom", ["lo0", "lo642"])
def test_planes_match_jax_pair_mm(geom, use_temporal, g_shifted, parent_dtype):
    """(b) Against JAX interface_planes_pair_mm on a parent and child padded
    to the TPU tile, planes in the reference's g_native rule: bf16 g-space
    planes from bf16 states with `g_shifted`, float32 otherwise."""
    rng = np.random.default_rng(3)
    parent, child, parent_t, child_t = _levels(
        geom, child_padded=(14, 16, 16), parent_padded=(20, 16, 24))
    st_old, st_new = (_jax_state(rng, parent.padded, parent_dtype) for _ in range(2))
    bf16 = parent_dtype == "bfloat16"
    out_j = jnp.bfloat16 if bf16 and g_shifted else jnp.float32
    want = ds_jax.interface_planes_pair_mm(
        ds_jax.build_iface_mm_plan(child, parent), child, parent,
        st_old if use_temporal else None, st_new, use_temporal,
        g_shifted=g_shifted, out_dtype=out_j)
    old_t, new_t = (convert.state_from_jax({k: np.asarray(v) for k, v in s.items()},
                                           parent_t) for s in (st_old, st_new))
    out_t = torch.bfloat16 if bf16 and g_shifted else torch.float32
    got = _port_planes(child_t, parent_t, old_t, new_t, use_temporal, g_shifted, out_t)
    assert set(got) == set(want) == set(range(6))
    tol = 2e-3 if bf16 else 2e-6
    for face, pl in got.items():
        t = [a for a in range(3) if a != face // 2]
        A, B = child.interior[t[0]], child.interior[t[1]]
        assert pl.shape == (2 if use_temporal else 1, 27, A, B)
        assert pl.dtype == out_t and pl[0].is_contiguous()
        w = np.asarray(want[face]).astype(np.float32)
        if face // 2:  # x-rows leading (nw, A, 27, B) -> (nw, 27, A, B)
            w = w.transpose(0, 2, 1, 3)
        d = np.abs(convert.to_numpy(pl) - w[:, :, :A, :B]).max()
        assert d < tol, (face, d)


@pytest.mark.parametrize("parent_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_shifted", [True, False], ids=["g", "f"])
@pytest.mark.parametrize("use_temporal", [True, False], ids=["temporal", "frozen"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_planes_match_endpoint_path(geom, use_temporal, g_shifted, parent_dtype):
    """(c) Against the port's endpoint path (interface_endpoints[_pair] +
    interface_from_endpoints at weights 0.0 and 0.5) + shift_planes, in
    float32 (< 2e-6); the bf16 planes are the float32 ones cast."""
    rng = np.random.default_rng(5)
    _, _, parent, child = _levels(geom)
    old, new = (_port_state(rng, parent.interior, parent_dtype) for _ in range(2))
    got = _port_planes(child, parent, old, new, use_temporal, g_shifted, torch.float32)
    got16 = _port_planes(child, parent, old, new, use_temporal, g_shifted, torch.bfloat16)
    if use_temporal:
        ep_old, ep_new = ds.interface_endpoints_pair(child, parent, old, new)
    else:
        ep_old, ep_new = None, ds.interface_endpoints(child, parent, new)
    for n, tw in enumerate((0.0, 0.5)):
        raw = ds.interface_from_endpoints(ep_new, ep_old, child, parent, tw, use_temporal)
        want = ds.shift_planes(raw, child, g_shifted, torch.float32)
        for face in want:
            pl = got[face][n if use_temporal else 0]
            d = float((pl - want[face]).abs().max())
            assert d < 2e-6, (face, n, d)
    for face in got:
        assert torch.equal(got16[face], got[face].to(torch.bfloat16)), face


def _sphere(tmp, num_levels, surface_resolution=8, min_coarse_blocks=None, **kw):
    make_case_sphere(tmp, "1M", surface_resolution=surface_resolution,
                     num_levels=num_levels, steps=3,
                     ramp_steps=2, output_freq=100, diag_freq=100,
                     inlet_turbulence=0.02, **kw)
    if min_coarse_blocks is not None:
        path = f"{tmp}/config.yaml"
        with open(path) as fh:
            doc = yaml.safe_load(fh)
        doc["advanced"].setdefault("high_re", {})["min_coarse_blocks"] = min_coarse_blocks
        with open(path, "w") as fh:
            yaml.safe_dump(doc, fh, sort_keys=False)
    cfg = load_case_config(tmp)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    cfg, mesh, params = _sphere(str(tmp_path_factory.mktemp("sphere2_iface")), 2)
    levels = build_patches(cfg, mesh, params)
    assert len(levels) == 2
    return cfg, params, levels


def _rand_states(levels, precision, seed):
    rng = np.random.default_rng(seed)
    return [_port_state(rng, tuple(p.interior), precision) for p in levels]


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_carried_slabs_equal_fresh(sphere2, monkeypatch, precision):
    """(d) Three coarse steps: the slabs carried under "_ifsl" equal slabs
    freshly extracted from the parent's state bit for bit, and the planes
    and states equal those of the unseeded path (each step's old slabs
    extracted from the pre-step state)."""
    cfg, params, levels = sphere2
    cfg = dataclasses.replace(cfg, precision=precision)
    statics = sd.build_patch_statics(cfg, levels)
    step = sd.make_coarse_step_dense(cfg, params, levels, statics)
    made = []
    real = sd.interface_planes_pair_mm

    def record(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(sd, "interface_planes_pair_mm", record)
    carried = step.seed_slabs(_rand_states(levels, precision, 7))
    fresh = _rand_states(levels, precision, 7)
    plan = statics[1]["iface_mm"]
    for t in (1, 2, 3):
        carried = step(carried, t)
        fresh = step([{k: v for k, v in s.items() if k != "_ifsl"} for s in fresh], t)
        again = ds.extract_endpoint_slabs(plan, carried[0])
        for a, b in zip(carried[0]["_ifsl"], again):
            for key in ("f", "rho", "vel"):
                assert torch.equal(a[key], b[key]), (t, key)
        pc, pf = made[-2], made[-1]
        for face in pc:
            assert pc[face].shape[0] == 2 and torch.equal(pc[face], pf[face]), (t, face)
        for sc, sf in zip(carried, fresh):
            for key in ("f", "rho", "vel"):
                assert torch.equal(sc[key], sf[key]), (t, key)


def test_contraction_stays_within_its_bound(sphere2, monkeypatch):
    """(e) Every matmul operand and result of the contraction on the
    sphere's child level stays within 36 nf nw A B values (the rho and vel
    class planes: 4/3 of the f planes), while the outer product of UA3 and
    UB3 that a left-to-right contraction of the reference's specs would
    form is larger by far; and the check raises above its bound."""
    cfg, params, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    plan = statics[1]["iface_mm"]
    sizes = []
    real = torch.matmul

    def matmul(a, b):
        out = real(a, b)
        sizes.append(max(a.numel(), b.numel(), out.numel()))
        return out

    st = _rand_states(levels, "float32", 2)[0]
    slabs = ds.extract_endpoint_slabs(plan, st)
    monkeypatch.setattr(torch, "matmul", matmul)
    ds.interface_planes_pair_mm(plan, levels[1], levels[0], slabs, slabs, True)
    monkeypatch.setattr(torch, "matmul", real)
    assert len(sizes) == 4 * len(plan["groups"])
    bound = max(36 * len(g["faces"]) * 2 * g["A"] * g["B"] for g in plan["groups"])
    outer = max(9 * g["A"] * g["UA3"].shape[2] * g["B"] * g["UB3"].shape[2]
                for g in plan["groups"])
    assert max(sizes) <= bound < outer / 8, (max(sizes), bound, outer)
    with pytest.raises(AssertionError, match="exceeds its bound"):
        ds._check_intermediate((torch.zeros(10),), 9)


def test_main_path_never_calls_the_endpoint_path(sphere2, monkeypatch):
    """The scheduler builds every child's planes through the plan, the
    carried slabs and interface_planes_pair_mm: with the endpoint path
    patched to raise, a batch runs, seeded or not."""
    cfg, params, levels = sphere2

    def boom(*a, **k):
        raise AssertionError("the endpoint path was called")

    for name in ("interface_endpoints", "interface_endpoints_pair",
                 "interface_from_endpoints", "shift_planes"):
        monkeypatch.setattr(ds, name, boom)
    statics = sd.build_patch_statics(cfg, levels)
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    out = run(_rand_states(levels, cfg.precision, 4), 1, 2)
    assert "_ifsl" in out[0] and "_ifsl" not in out[1]
    out = sd.make_coarse_step_dense(cfg, params, levels, statics)(
        _rand_states(levels, cfg.precision, 4), 1)
    assert all(torch.isfinite(s["rho"]).all() for s in out)


def test_engine_log_and_memory_report_name_the_planes(sphere2):
    cfg, params, levels = sphere2
    statics = sd.build_patch_statics(cfg, levels)
    for precision, space in (("bfloat16", "bf16 g-space"), ("float32", "f32 f-space")):
        lines = sd.kernel_log_lines(levels, statics, precision, "cpu")
        assert "ghost planes: einsum" not in lines[0]
        assert f"ghost planes: einsum plan, 3 groups, {space}" in lines[1]
    report = sd.hbm_report_patches(levels, statics, "bfloat16")
    assert "carried ghost-plane slabs" in report.splitlines()[1]
    assert "pre-step state is not held" in report


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


@pytest.fixture(scope="module")
def sphere3(tmp_path_factory):
    """3-level sphere, surface_resolution 6, one coarse block a side, no
    wake box: level 1 16x16x16 (flat in both packages), level 2 24x24x24
    at lo (4, 4, 4), level 3 34x40x40 at lo (12, 12, 12)."""
    cfg, mesh, params = _sphere(str(tmp_path_factory.mktemp("sphere3_iface")), 3,
                                surface_resolution=6, min_coarse_blocks=1,
                                wake_enabled=False)
    with _backend_as_tpu():
        levels_j = build_patches_jax(cfg, mesh, params)
    levels_t = build_patches(cfg, mesh, params)
    assert len(levels_t) == 3 and tuple(levels_t[1].lo) != (0, 0, 0)
    assert [p.flat_yz for p in levels_j] == [True, False, False]
    return cfg, params, levels_j, levels_t


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sphere3_matches_jax_pallas(sphere3, precision):
    """Two coarse steps from one random state: the port (level 1 on K4's
    plain version, level 2 on K1's, level 3's pairs on K3's, every ghost
    plane from the einsum pipeline) against the JAX package's Pallas path in
    interpret mode, per level."""
    t0 = time.time()
    cfg, params, levels_j, levels_t = sphere3
    cfg = dataclasses.replace(cfg, precision=precision)
    statics_t = sd.build_patch_statics(cfg, levels_t)
    assert [s["engine"] for s in statics_t] == ["flat", "k1", "k1"]
    states_t = _rand_states(levels_t, precision, 21)
    states_j = []
    dt = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    for s, p in zip(states_t, levels_j):
        a = convert.state_to_jax(s, p)
        states_j.append({"f": jnp.asarray(a["f"]).astype(dt),
                         "rho": jnp.asarray(a["rho"]), "vel": jnp.asarray(a["vel"])})
    run_j = sd_jax.make_batch_runner_dense(
        cfg, params, levels_j, sd_jax.build_patch_statics(cfg, levels_j),
        use_pallas=True)
    assert run_j.pallas_levels == (True, True, True) and run_j.fused2
    states_j = run_j(states_j, np.int32(1), 2)
    # the JAX package's schedule (K3 pairs on level 3), and the port's
    # default (unfused), each from the same states
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t, statics_t, fuse2=True)
    assert run_t.fused2
    run_d = sd.make_batch_runner_dense(cfg, params, levels_t, statics_t)
    assert not run_d.fused2
    states_d = run_d(list(states_t), 1, 2)
    states_t = run_t(states_t, 1, 2)

    tol = 2e-3 if precision == "bfloat16" else 2e-5
    for li, (p, sj, st, sdf) in enumerate(zip(levels_j, states_j, states_t,
                                              states_d)):
        for label, s in (("fused", st), ("default", sdf)):
            got = convert.state_to_numpy(s)
            for key in ("f", "rho", "vel"):
                want = convert.from_jax_layout(np.asarray(sj[key]).astype(np.float32),
                                               p)
                d = np.abs(got[key] - want).max()
                assert d < tol, (label, li, key, d)
    print(f"sphere3 {precision}: {time.time() - t0:.1f} s")


def test_profile_slice_counts_busy_time_once():
    """The phase-5 profile's device-busy time is the union of the device
    operations' intervals (overlaps counted once), and its name filter
    tells the port's kernels from the glue's."""
    from types import SimpleNamespace

    from open_ludwig_torch.tools import profile_slice

    def ev(a, b):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b))

    assert profile_slice.busy_us([ev(0, 10), ev(5, 12), ev(20, 25), ev(21, 22)]) == 17
    assert profile_slice.busy_us([]) == 0
    names = ["void (anonymous namespace)::stream_collide_kernel<__nv_bfloat16>(sc::Params)",
             "void (anonymous namespace)::fused_pair_kernel<float>(Params)",
             "void link_kernel<SLink, __nv_bfloat16>(SLink, __nv_bfloat16*, float*, int)",
             "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
             "ampere_sgemm_32x32_sliced1x4_nn", "Memcpy HtoD (Pageable -> Device)"]
    assert [bool(profile_slice.PORT_KERNEL.search(n)) for n in names] == \
        [True, True, True, False, False, False]


def test_profile_slice_drops_an_incomplete_trace():
    """A profile that kept fewer device operations than the port executed
    launches is not read as measured: its device numbers become None."""
    from open_ludwig_torch.tools import profile_slice

    def prof(ops):
        return {"device_ops": ops, "port_kernels": 1.0, "port_device_ms": 0.5,
                "other_device_ms": 0.1, "busy_share": 0.4, "window_ms": 2.0}

    kept = profile_slice.drop_incomplete(prof(548.0), 246.0)
    assert kept["device_ops"] == 548.0 and kept["busy_share"] == 0.4
    for ops, launches in ((0.7, 2.0), (0.0, 0.0), (245.0, 246.0)):
        lost = profile_slice.drop_incomplete(prof(ops), launches)
        assert all(lost[k] is None for k in ("device_ops", "port_kernels",
                                             "port_device_ms", "other_device_ms",
                                             "busy_share"))
        assert lost["window_ms"] == 2.0

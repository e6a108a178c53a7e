"""K5 (the in-place step of an interface-free level) of the PyTorch port
against the JAX package.

- K5's plain version (the CPU path of
  `open_ludwig_torch.ops.cuda_step.stream_collide_inplace`) against
  `make_pallas_step_2d(interpret=True, chunk_dims=(2, 8), alias_f=True)` on
  the (8, 24, 120) level of tests/test_patch_pallas.py:117-163 (every face
  type, wall model, sponge, inlet noise): float32 < 1e-5, bf16 g-storage
  < 2e-3;
- the wrapper updates the f it is given and returns that storage, with
  fresh rho and vel;
- a single-level runner and the parent level of a 2-level sphere forced
  onto K5 equal the K1 schedule bit for bit;
- the reference's fused pair declines the K5 shapes, so a K5 level runs
  unfused in both packages; the engine log and the memory report say so.
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.ops.pallas_step import (
    make_pallas_step_2d, make_pallas_step_fused2, prepare_pallas_statics,
)
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert, memory
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import cuda_step, engine, storage
from open_ludwig_torch.ops.cuda_step import stream_collide, stream_collide_inplace

torch.set_num_threads(1)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
KW = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=0.02,
          wall_model=True, sponge_blend=True)


def _jax_level(interior, face_bc=DOMAIN, tau=0.53, fields=True):
    X, Y, Z = interior
    padded = (X, -(-Y // 8) * 8, -(-Z // 128) * 128)
    sh = padded if fields else (1, 1, 1)
    return PatchLevel(1, 0.1, tau, (0, 0, 0), tuple(interior), padded,
                      tuple(face_bc), np.zeros(sh, bool),
                      np.zeros(sh, np.float32), np.full(sh, 100.0, np.float32))


def _port_static(tp):
    return {"obstacle": torch.as_tensor(tp.obstacle),
            "sponge": torch.as_tensor(tp.sponge),
            "wall_dist": torch.as_tensor(tp.wall_dist)}


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_inplace_plain_matches_pallas_2d(rng, store_bf16):
    X, Y, Z = 8, 24, 120
    p = _jax_level((X, Y, Z))
    p.obstacle[3:5, 9:12, 50:54] = True
    p.sponge[6:, :, :] = 0.3
    p.wall_dist[2, 10, 49] = 1.0
    f0 = (lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + p.padded))).astype(np.float32)
    v0 = (0.02 * rng.standard_normal((3,) + p.padded)).astype(np.float32)
    w = lat.W.astype(np.float32)[:, None, None, None]
    fj = jnp.asarray(f0 - w).astype(jnp.bfloat16) if store_bf16 else jnp.asarray(f0)
    pstep = make_pallas_step_2d(p, interpret=True, store_bf16=store_bf16,
                                chunk_dims=(2, 8), alias_f=True, **KW)
    want = pstep(fj, jnp.asarray(v0), jnp.float32(0.04), jnp.int32(9),
                 prepare_pallas_statics(p))
    want = [convert.trim(np.asarray(a).astype(np.float32), p.interior) for a in want]

    tp = convert.level_from_jax(p)
    f_t = convert.to_tensor(convert.trim(np.asarray(fj), tp.interior))
    v_t = torch.as_tensor(convert.trim(v0, tp.interior)).contiguous()
    got = stream_collide_inplace(f_t, v_t, 0.04, 9, _port_static(tp), tp, **KW)
    tol = 2e-3 if store_bf16 else 1e-5
    df = np.abs(storage.decode_f(got[0]).numpy()
                - (want[0] + (w if store_bf16 else 0.0))).max()
    dr = np.abs(got[1].numpy() - want[1]).max()
    dv = np.abs(got[2].numpy() - want[2]).max()
    assert df < tol and dr < tol and dv < tol, (df, dr, dv)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_inplace_wrapper_updates_its_input(store_bf16):
    """K5's contract: f is updated in its own storage and returned; rho and
    vel are fresh, vel_in unchanged; the values are K1's."""
    rng = np.random.default_rng(4)
    X, Y, Z = 6, 5, 7
    tp = convert.level_from_jax(_jax_level((X, Y, Z)))
    tp.obstacle[2:4, 1:3, 2:4] = True
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27, X, Y, Z)))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, "bfloat16")
    vel = torch.as_tensor((0.02 * rng.standard_normal((3, X, Y, Z))).astype(np.float32))
    f_before, vel_before = f.clone(), vel.clone()
    st = _port_static(tp)
    want = stream_collide(f_before, vel, 0.04, 5, st, tp, **KW)
    cuda_step.reset_launches()
    ptr = f.data_ptr()
    got = stream_collide_inplace(f, vel, 0.04, 5, st, tp, **KW)
    assert got[0] is f and got[0].data_ptr() == ptr
    assert not torch.equal(f, f_before)
    assert torch.equal(vel, vel_before) and got[2].data_ptr() != vel.data_ptr()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cuda_step.LAUNCHES["stream_collide_inplace"] == 0  # plain path
    with pytest.raises(ValueError, match="interface"):
        stream_collide_inplace(f, vel, 0.04, 5, st, dataclasses.replace(
            tp, face_bc=DOMAIN[:2] + (BC_INTERFACE,) + DOMAIN[3:]), **KW)


def _case(tmp, **kw):
    make_case_sphere(tmp, "1M", steps=6, ramp_steps=3, output_freq=100,
                     diag_freq=100, inlet_turbulence=0.02, **kw)
    cfg = load_case_config(tmp)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, params, build_patches(cfg, mesh, params)


def _rand_states(levels, precision, seed):
    rng = np.random.default_rng(seed)
    out = []
    for p in levels:
        sh = tuple(p.interior)
        f = (lat.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
            (27,) + sh))).astype(np.float32)
        out.append({"f": storage.encode_f(torch.as_tensor(f), precision),
                    "rho": torch.ones(sh),
                    "vel": torch.as_tensor((0.02 * rng.standard_normal((3,) + sh))
                                           .astype(np.float32))})
    return out


def _forced(statics, engs):
    """The statics with each level's kernel forced to engs[l]."""
    return [{**st, "engine": e} for st, e in zip(statics, engs)]


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_forced_inplace_single_level_equals_k1(tmp_path, precision):
    """A single-level case (Bouzidi, wall model, inlet noise) forced onto
    K5 for 3 coarse steps equals the K1 schedule, unfused and fused."""
    cfg, params, levels = _case(str(tmp_path), surface_resolution=10,
                                num_levels=1, boundary_method="bouzidi",
                                precision=precision)
    statics = sd.build_patch_statics(cfg, levels)
    assert statics[0]["bouzidi"] is not None
    run5 = sd.make_batch_runner_dense(cfg, params, levels,
                                      _forced(statics, ["inplace"]))
    assert not run5.fused2
    got = run5(_rand_states(levels, precision, 8), 1, 3)
    for fuse2 in (False, True):
        run1 = sd.make_batch_runner_dense(cfg, params, levels,
                                          _forced(statics, ["k1"]), fuse2=fuse2)
        assert run1.fused2 == fuse2
        want = run1(_rand_states(levels, precision, 8), 1, 3)
        for key in ("f", "rho", "vel"):
            assert torch.equal(got[0][key], want[0][key]), (fuse2, key)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_forced_inplace_parent_level_equals_k1(tmp_path, precision):
    """The 2-level sphere with level 1 on K5 (its old ghost-plane endpoints
    taken before the in-place step), on K4 (the reference's choice) and on
    K1: two coarse steps agree bit for bit on every level."""
    cfg, params, levels = _case(str(tmp_path), surface_resolution=8,
                                num_levels=2, precision=precision)
    statics = sd.build_patch_statics(cfg, levels)
    assert statics[0]["engine"] == "flat"
    out = {}
    for engs in (("inplace", "k1"), ("flat", "k1"), ("k1", "k1")):
        run = sd.make_batch_runner_dense(cfg, params, levels,
                                         _forced(statics, engs))
        states = _rand_states(levels, precision, 9)
        f0 = states[0]["f"]
        out[engs] = run(states, 1, 2)
        assert (out[engs][0]["f"] is f0) == (engs[0] == "inplace")
    for engs in (("inplace", "k1"), ("flat", "k1")):
        for li in range(2):
            for key in ("f", "rho", "vel"):
                assert torch.equal(out[engs][li][key], out[("k1", "k1")][li][key]), \
                    (engs, li, key)


@pytest.mark.parametrize("engs", [("k1", "k1"), ("inplace", "k1")],
                         ids=["k1", "k5-parent"])
def test_batch_frees_each_steps_outputs(tmp_path, engs):
    """A coarse step's rho and vel are freed once the next step has run,
    without the garbage collector: held on, they would cost a 63.7M-cell
    level 1 GB per step.  The eager loop frees them; the graphed runner
    writes every step into the same two buffers per array (A/B), so over
    many calls the arrays it returns lie at two addresses where a level
    steps once a coarse step (level 1) and at one where it steps twice
    (level 2 returns to its buffer), one f on a K5 level: the memory it
    holds does not grow."""
    cfg, params, levels = _case(str(tmp_path), surface_resolution=8, num_levels=2)
    statics = _forced(sd.build_patch_statics(cfg, levels), engs)
    run = sd.make_batch_runner_dense(cfg, params, levels, statics, fuse2=False,
                                     graphs=False)
    gc.collect()
    gc.disable()
    try:
        states = run(_rand_states(levels, cfg.precision, 3), 1, 1)
        refs = [weakref.ref(st["rho"]) for st in states]
        states = run(states, 2, 1)
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
    run = sd.make_batch_runner_dense(cfg, params, levels, statics, fuse2=False)
    states = run(_rand_states(levels, cfg.precision, 3), 1, 1)
    seen = [{k: set() for k in ("f", "rho", "vel")} for _ in levels]
    for t in range(2, 8):
        states = run(states, t, 1)
        for lvl, st in enumerate(states):
            for k in seen[lvl]:
                seen[lvl][k].add(st[k].data_ptr())
    for lvl, eng in enumerate(engs):
        n = 2 if lvl == 0 else 1
        assert len(seen[lvl]["rho"]) == len(seen[lvl]["vel"]) == n, seen[lvl]
        assert len(seen[lvl]["f"]) == (1 if eng == "inplace" else n), seen[lvl]


@pytest.mark.parametrize("eng", ["inplace", "flat"])
def test_interface_free_engine_on_interface_level_raises(tmp_path, eng):
    """K4 and K5 refuse the 2-level sphere's finest level (interface faces)
    before they launch."""
    cfg, params, levels = _case(str(tmp_path), surface_resolution=8, num_levels=2)
    statics = _forced(sd.build_patch_statics(cfg, levels), ["k1", eng])
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    cuda_step.reset_launches()
    with pytest.raises(ValueError, match="interface"):
        run(_rand_states(levels, cfg.precision, 5), 1, 1)


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("interior", [(432, 384, 384), (320, 304, 384)],
                         ids=["63.7M", "37.4M"])
def test_reference_fused_pair_declines_k5_shapes(interior, store_bf16):
    """make_pallas_step_fused2 returns None at the sweep rows' shapes, so
    the reference runs them unfused; the card's rule runs them on K5 at a
    capacity one byte under their A -> B estimate, and a K5 level takes no
    K3, also under fuse2=True."""
    jp = _jax_level(interior, fields=False)
    kw = dict(KW, inlet_turbulence=0.0)
    assert make_pallas_step_fused2(jp, store_bf16=store_bf16, alias_f=True,
                                   **kw) is None
    tp = convert.level_from_jax(jp)
    precision = "bfloat16" if store_bf16 else "float32"

    def need(engs):
        return memory.case_bytes([tp], engs, precision)["device"]

    (eng, why), = engine.card_engines([tp], need(["k1"]) - 1, need)
    assert eng == "inplace", why
    st = {"engine": eng, "engine_why": why, "bouzidi": None, "iface_mm": None}
    line, = sd.kernel_log_lines([tp], [st], precision, "cpu", fuse2=True)
    assert "K3 no: K5 runs one sub-step per launch" in line


def test_kernel_log_and_memory_report_name_k5(tmp_path):
    cfg, params, levels = _case(str(tmp_path), surface_resolution=10,
                                num_levels=1, precision="bfloat16")
    statics = sd.build_patch_statics(cfg, levels)
    statics[0] = {**statics[0], "engine": "inplace", "engine_why": "forced"}
    lines = sd.kernel_log_lines(levels, statics, "bfloat16", "cpu")
    assert "K5 stream_collide_inplace (in place) plain torch (CPU)" in lines[0]
    assert "K3 no: K5 runs one sub-step per launch" in lines[0]
    report = sd.hbm_report_patches(levels, statics, "bfloat16")
    n = levels[0].n_cells
    assert f"K5 in place: rho/vel {n * 16 / 1e6:.1f} MB" in report
    assert "K3 A->B" not in report
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    assert not run.fused2
    states = _rand_states(levels, "bfloat16", 6)
    f0 = states[0]["f"]
    f_before = f0.clone()
    run(states, 1, 1)
    assert not torch.equal(f0, f_before)  # K5 wrote into the state's f

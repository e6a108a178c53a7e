"""The port's slice end to end against the JAX package: a 2-level sphere
(surface_resolution 8, wall model, wake box, Bouzidi on the finest level,
inlet noise 0.02) carried across with `open_ludwig_torch.convert`.

- a few coarse steps of the port on the CPU against the JAX XLA path
  (`make_batch_runner_dense(use_pallas=False)`) from the same random state:
  every level's f, rho and vel within 2e-5 in float32 and 2e-3 on bf16
  g-storage;
- Cd/Cl of one state through both force paths within 1e-5;
- `runner.solve_case` writes the JAX runner's CSV columns.
"""

import csv
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu import solver_dense as sd_jax
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.io import csv_out as csv_jax
from open_ludwig_tpu.ops import forces as forces_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert, runner
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import forces

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere2"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=3,
                     ramp_steps=2, output_freq=100, diag_freq=100,
                     inlet_turbulence=0.02)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    levels_j = build_patches_jax(cfg, mesh, params)
    levels_t = build_patches(cfg, mesh, params)
    assert len(levels_t) == 2 and levels_t[-1].bouzidi is not None
    return cfg, mesh, params, levels_j, levels_t


def _random_states(levels_j, precision, rng):
    states = []
    for p in levels_j:
        f = (lat.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
            (27,) + p.padded))).astype(np.float32)
        states.append({
            "f": storage_jax.encode_f(jnp.asarray(f), precision),
            "rho": jnp.asarray((1 + 0.01 * rng.standard_normal(p.padded))
                               .astype(np.float32)),
            "vel": jnp.asarray((0.02 * rng.standard_normal((3,) + p.padded))
                               .astype(np.float32)),
        })
    return states


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_slice_matches_jax(sphere2, precision):
    cfg, mesh, params, levels_j, levels_t = sphere2
    cfg = dataclasses.replace(cfg, precision=precision)
    statics_j = sd_jax.build_patch_statics(cfg, levels_j)
    statics_t = sd.build_patch_statics(cfg, levels_t)
    # the converter gives the port's statics from the JAX ones
    for p, sj, st in zip(levels_j, statics_j, statics_t):
        conv = convert.statics_from_jax(
            {k: np.asarray(v) if k != "bouzidi" else v for k, v in sj.items()},
            p, st["bouzidi"])
        for key in ("obstacle", "sponge", "wall_dist"):
            assert torch.equal(conv[key], st[key]), key
        if st["bouzidi"] is not None:
            assert torch.equal(conv["bouzidi"]["S"], st["bouzidi"]["S"])

    states_j = _random_states(levels_j, precision, np.random.default_rng(21))
    states_t = [convert.state_from_jax({k: np.asarray(v) for k, v in s.items()}, p)
                for s, p in zip(states_j, levels_j)]
    n = 2
    run_j = sd_jax.make_batch_runner_dense(cfg, params, levels_j, statics_j,
                                           use_pallas=False)
    states_j = run_j(states_j, np.int32(1), n)
    run_t = sd.make_batch_runner_dense(cfg, params, levels_t, statics_t)
    states_t = run_t(states_t, 1, n)

    tol = 2e-3 if precision == "bfloat16" else 2e-5
    for li, (p, sj, st) in enumerate(zip(levels_j, states_j, states_t)):
        assert st["f"].dtype == (torch.bfloat16 if precision == "bfloat16"
                                 else torch.float32)
        # compared in the storage space (g for bf16), both as float32
        want = {key: convert.trim(np.asarray(sj[key]).astype(np.float32),
                                  p.interior) for key in ("f", "rho", "vel")}
        got = convert.state_to_numpy(st)
        for key in want:
            d = np.abs(got[key] - want[key]).max()
            assert d < tol, (li, key, d)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_forces_match_jax(sphere2, extrapolate):
    cfg, mesh, params, levels_j, levels_t = sphere2
    rng = np.random.default_rng(5)
    st_j = _random_states(levels_j[-1:], "float32", rng)[0]
    ctx_j = forces_jax.make_force_context_dense(mesh, levels_j[-1], params,
                                                extrapolate=extrapolate)
    ctx_t = forces.make_force_context_dense(mesh, levels_t[-1], params,
                                            extrapolate=extrapolate)
    p = levels_j[-1]
    for key in ("cell_idx", "cell_idx2"):
        want = convert.cell_index_from_jax(np.asarray(getattr(ctx_j, key)),
                                           p.padded, p.interior)
        assert np.array_equal(getattr(ctx_t, key).numpy(), want), key
    fr_j = forces_jax.compute_aerodynamics(st_j, ctx_j)
    fr_t = forces.compute_aerodynamics(
        convert.state_from_jax({k: np.asarray(v) for k, v in st_j.items()}, p),
        ctx_t)
    assert abs(fr_j.Cd) > 1e-3
    for name in ("Cd", "Cl", "Cs", "Cmy"):
        assert abs(getattr(fr_t, name) - getattr(fr_j, name)) < 1e-5, name
    assert np.allclose(fr_t.pressure_map, np.asarray(fr_j.pressure_map),
                       rtol=1e-5, atol=1e-3)


def test_solve_case_writes_jax_csv_columns(sphere2, tmp_path):
    cfg = dataclasses.replace(sphere2[0], case_dir=str(tmp_path), steps=2,
                              diag_freq=1, output_freq=2)
    for name in ("sphere.stl",):
        with open(os.path.join(sphere2[0].case_dir, name), "rb") as src, \
                open(os.path.join(str(tmp_path), name), "wb") as dst:
            dst.write(src.read())
    res = runner.solve_case(cfg, device="cpu")
    assert res.steps == 2 and res.final_stats.rho_min > 0.5
    out = cfg.output_path
    for fname, header in (("convergence.csv", csv_jax.CONVERGENCE_HEADER),
                          ("forces.csv", csv_jax.FORCES_HEADER)):
        with open(os.path.join(out, fname)) as fh:
            rows = list(csv.reader(fh))
        assert ",".join(rows[0]) == header, fname
        assert len(rows) == 3, (fname, rows)
        assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[2:]), rows


def test_runner_refuses_unported_configs(sphere2):
    """A layout the runner does not know is refused; the blocks layout
    (tests/test_torch_blocks_runner.py) and several devices pass (the
    x-slab path, tests/test_torch_shard_runner.py), as momentum exchange
    and checkpoints do (tests/test_torch_checkpoint_runner.py)."""
    cfg = sphere2[0]
    with pytest.raises(ValueError, match="layout: octree is unknown"):
        runner.check_supported(dataclasses.replace(cfg, layout="octree"))
    runner.check_supported(dataclasses.replace(cfg, layout="blocks"))
    runner.check_supported(dataclasses.replace(cfg, devices=2))


def test_cuda_request_without_cuda_raises():
    """No silent CPU fallback: asking for cuda on a host without it raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.resolve_device("cuda")


def test_plain_path_counts_no_kernel_launches(sphere2):
    """The launch counters move only where a kernel launches: a CPU run of
    the schedule (plain versions) leaves them at zero."""
    from open_ludwig_torch.ops import cuda_step

    cfg, _, params, _, levels_t = sphere2
    statics = sd.build_patch_statics(cfg, levels_t)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels_t]
    cuda_step.reset_launches()
    sd.make_batch_runner_dense(cfg, params, levels_t, statics)(states, 1, 1)
    assert cuda_step.LAUNCHES == {"stream_collide": 0, "bouzidi": 0,
                                  "fused_pair": 0, "stream_collide_flat": 0,
                                  "stream_collide_inplace": 0, "bouzidi_ab": 0,
                                  "stream_collide_shard": 0, "bouzidi_shard": 0,
                                  "stream_collide_flat_shard": 0,
                                  "stream_collide_inplace_shard": 0}

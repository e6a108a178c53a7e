"""`layout: blocks` through the port's runner, against the JAX package's.

- the tiny case of tests/test_runner_e2e.py:110 (sphere, 1 level, 20
  coarse steps, diagnostics every 10, a flow file at 20, checkpoints every
  10) through both runners on the CPU: rho_min > 0.8 and a finite Cd;
  convergence.csv and forces.csv with the JAX run's steps; rho_min within
  2e-5 relative; the final states within 2e-5 (the reference's multi-level
  tolerance); Cd within what the two final states' difference can move it
  (from rest the flow has not reached the sphere after 20 steps, so Cd is
  float32 rounding noise in both runs, and a relative bound on it means
  nothing);
- the flow file's arrays against the JAX export's (1e-5), and
  `vorticity_blocks_host` equal to the JAX one;
- precision bfloat16, `forces.method: momentum_exchange` and `devices: 2`
  each log the JAX runner's warning or build no mesh, and run float32 with
  stress mapping on one device;
- a resumed blocks run bit-equal to the uninterrupted one; a JAX blocks
  checkpoint resumed by the port through `convert.checkpoint_from_jax`,
  and a port checkpoint read by the JAX package through
  `convert.checkpoint_to_jax`;
- `async_depth` (tests/test_runner_e2e.py:98-107): 3 coarse steps per call
  gives the convergence steps [10, 20] and the states of one call per
  batch bit for bit, on both layouts.
"""

import csv
import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from open_ludwig_tpu import checkpoint as ckpt_jax
from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.diagnostics import vorticity_blocks_host as vorticity_jax
from open_ludwig_tpu.domain.builder import setup_case as setup_case_jax
from open_ludwig_tpu.runner import solve_case as solve_case_jax

from open_ludwig_torch import checkpoint as ckpt
from open_ludwig_torch import convert, runner
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.diagnostics import vorticity_blocks_host
from open_ludwig_torch.domain.builder import setup_case
from open_ludwig_torch.io import vtk
from open_ludwig_torch.ops import forces

torch.set_num_threads(2)

TINY = dict(surface_resolution=10, num_levels=1, steps=20, ramp_steps=10,
            output_freq=20, diag_freq=10, wake_enabled=False,
            boundary_method="bounce_back", wall_model=False)


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _steps(out_dir, name):
    return [int(r["Step"]) for r in _rows(os.path.join(out_dir, name))]


def _ckpt(out_dir, step):
    return os.path.join(out_dir, "checkpoints", f"ckpt_{step:08d}.npz")


def _with_vorticity(cfg):
    return dataclasses.replace(cfg, output_fields=dataclasses.replace(
        cfg.output_fields, vorticity=True))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    make_case_sphere(d, "1M", **TINY)
    return d


@pytest.fixture(scope="module")
def pair(tiny):
    """The tiny case on the blocks layout through both runners."""
    over = dict(layout="blocks", checkpoint_freq=10)
    cfg = _with_vorticity(load_case_config(tiny).with_overrides(
        output_dir="RESULTS_PORT", **over))
    cfg_j = _with_vorticity(load_case_config_jax(tiny).with_overrides(
        output_dir="RESULTS_JAX", **over))
    res = runner.solve_case(cfg, device="cpu")
    res_j = solve_case_jax(cfg_j)
    return cfg, res, cfg_j, res_j


def test_blocks_runner_matches_jax(pair):
    cfg, res, cfg_j, res_j = pair
    assert res.final_stats.rho_min > 0.8 and np.isfinite(res.final_forces.Cd)
    assert res.total_cells == res_j.total_cells
    for name in ("convergence.csv", "forces.csv"):
        assert _steps(cfg.output_path, name) == _steps(cfg_j.output_path, name)
    assert _steps(cfg.output_path, "convergence.csv") == [10, 20]
    rmin, rmin_j = res.final_stats.rho_min, res_j.final_stats.rho_min
    assert abs(rmin - rmin_j) <= 2e-5 * abs(rmin_j)
    _, got = ckpt.load_checkpoint(_ckpt(cfg.output_path, 20))
    _, want = ckpt_jax.load_checkpoint(_ckpt(cfg_j.output_path, 20))
    diff = {}
    for key in ("f", "rho", "vel"):
        diff[key] = float(np.abs(got[0][key].numpy() - np.asarray(want[0][key])).max())
        assert diff[key] < 2e-5, (key, diff[key])
    # Cd: the stress map is linear in rho - 1 and in u at the mapped cells
    # (pressure extrapolation at most triples a sample), so the states'
    # difference bounds the coefficients' difference
    mesh, params, levels = setup_case(cfg)
    ctx = forces.make_force_context(mesh, levels[-1], params,
                                    extrapolate=cfg.force_extrapolate)
    area = float(ctx.areas.double().sum())
    nu = (ctx.tau_molecular - 0.5) / 3.0
    f_ref = ctx.q_inf * ctx.area_ref
    bound = ctx.pressure_scale * area / f_ref * (
        diff["rho"] + 4 * nu * (diff["rho"] + diff["vel"])) + 1e-9
    assert abs(res.final_forces.Cd - res_j.final_forces.Cd) <= bound
    # the forces of each run are its own final state's
    fr = forces.compute_aerodynamics(got[0], ctx)
    assert fr.Cd == res.final_forces.Cd


def test_flow_file_matches_jax(pair, tmp_path):
    cfg, _, cfg_j, _ = pair
    got = vtk.read_vtu(os.path.join(cfg.output_path, "flow_000020.vtu"))
    want = vtk.read_vtu(os.path.join(cfg_j.output_path, "flow_000020.vtu"))
    assert sorted(got) == sorted(want) and "Vorticity" in got
    for name in want:
        assert got[name].dtype == want[name].dtype and \
            got[name].shape == want[name].shape, name
        if want[name].dtype.kind == "f" and name != "Points":
            d = np.abs(got[name] - want[name]).max()
            assert d < 1e-5, (name, d)
        else:
            assert np.array_equal(got[name], want[name]), name
    # the vorticity itself, on a random field over the case's blocks
    _, _, levels_j = setup_case_jax(cfg_j)
    g = levels_j[0]
    vel = np.random.default_rng(4).standard_normal((3, g.n_blocks, 512)).astype(np.float32)
    w = vorticity_blocks_host(torch.from_numpy(vel), g.coords, g.dims)
    assert np.array_equal(w, vorticity_jax(vel, g.coords, g.dims))


@pytest.mark.parametrize("case", ["bfloat16", "momentum_exchange", "devices2"])
def test_blocks_fallbacks(tmp_path, caplog, case):
    """What the JAX runner's blocks branch does with options of the patch
    layout: bf16 precision warns and runs float32, momentum exchange warns
    and maps stresses, `devices` builds no mesh."""
    make_case_sphere(str(tmp_path), "1M", **dict(TINY, surface_resolution=6,
                                                 steps=2, diag_freq=2,
                                                 output_freq=100))
    over = {"bfloat16": dict(precision="bfloat16"),
            "momentum_exchange": dict(force_method="momentum_exchange"),
            "devices2": dict(devices=2)}[case]
    cfg = load_case_config(str(tmp_path)).with_overrides(
        layout="blocks", checkpoint_freq=2, **over)
    assert runner.resolve_mesh(cfg, torch.device("cpu"), None) is None
    with caplog.at_level(logging.INFO, logger="open_ludwig_torch"):
        res = runner.solve_case(cfg, device="cpu")
    log = caplog.text
    assert res.final_stats.rho_min > 0.8 and np.isfinite(res.final_forces.Cd)
    assert "[Mesh]" not in log and "stress mapping (blocks layout)" in log
    _, st = ckpt.load_checkpoint(_ckpt(cfg.output_path, 2))
    assert st[0]["f"].dtype == torch.float32 and st[0]["f"].shape[0] == 27
    if case == "bfloat16":
        assert "precision=bfloat16 is only supported on layout=patch" in log
    if case == "momentum_exchange":
        assert "falling back to stress mapping" in log
        assert res.final_forces.force_map is None


def test_blocks_resume_is_bit_equal(pair, tmp_path):
    """The port's run resumed from its step-10 checkpoint ends bit-equal to
    the uninterrupted run, with each CSV step once."""
    cfg = pair[0]
    out = str(tmp_path / "resumed")
    shutil.copytree(cfg.output_path, out)
    os.remove(_ckpt(out, 20))
    cfg2 = cfg.with_overrides(output_dir=out, checkpoint_resume=True)
    res = runner.solve_case(cfg2, device="cpu")
    assert res.resume_step == 10
    _, full = ckpt.load_checkpoint(_ckpt(cfg.output_path, 20))
    _, resumed = ckpt.load_checkpoint(_ckpt(out, 20))
    for key in ("f", "rho", "vel"):
        assert torch.equal(full[0][key], resumed[0][key]), key
    for name in ("convergence.csv", "forces.csv"):
        assert _steps(out, name) == [10, 20]


def test_jax_blocks_checkpoint_resumes_in_port_and_back(pair, tmp_path):
    """The JAX run's step-10 checkpoint, converted, resumed by the port to
    step 20: within 2e-5 of the JAX run's step 20.  The port's step-20
    checkpoint, converted back, loads in the JAX package bit for bit."""
    cfg, _, cfg_j, _ = pair
    _, _, levels_j = setup_case_jax(cfg_j)
    out = str(tmp_path / "from_jax")
    convert.checkpoint_from_jax(_ckpt(cfg_j.output_path, 10), levels_j,
                                os.path.join(out, "checkpoints"))
    res = runner.solve_case(cfg.with_overrides(output_dir=out, checkpoint_resume=True),
                            device="cpu")
    assert res.resume_step == 10
    _, got = ckpt.load_checkpoint(_ckpt(out, 20))
    _, want = ckpt_jax.load_checkpoint(_ckpt(cfg_j.output_path, 20))
    for key in ("f", "rho", "vel"):
        assert np.abs(got[0][key].numpy() - np.asarray(want[0][key])).max() < 2e-5
    pj = convert.checkpoint_to_jax(_ckpt(cfg.output_path, 20), levels_j,
                                   str(tmp_path / "to_jax"))
    step, back = ckpt_jax.load_checkpoint(pj)
    _, port = ckpt.load_checkpoint(_ckpt(cfg.output_path, 20))
    assert step == 20
    for key in ("f", "rho", "vel"):
        assert np.array_equal(np.asarray(back[0][key]), port[0][key].numpy()), key


@pytest.mark.parametrize("layout", ["patch", "blocks"])
def test_async_depth_subbatching(tmp_path, layout):
    """async_depth bounds the coarse steps per call of the batch runner
    without changing results (reference: gpu.async_depth,
    main.jl:166-180): 3 per call (a batch of 10 in calls of 3, 3, 3, 1; on
    the patch layout's single level, a plain step and a pair, ..., a plain
    step) against one call per batch (5 pairs), bit for bit."""
    make_case_sphere(str(tmp_path), "1M", **dict(TINY, surface_resolution=6))
    base = load_case_config(str(tmp_path)).with_overrides(
        layout=layout, checkpoint_freq=20, precision="float32")
    finals = []
    for depth in (3, 0):
        cfg = base.with_overrides(async_depth=depth, output_dir=f"RESULTS_AD{depth}")
        res = runner.solve_case(cfg, device="cpu")
        assert res.final_stats.rho_min > 0.8
        assert _steps(cfg.output_path, "convergence.csv") == [10, 20]
        finals.append(ckpt.load_checkpoint(_ckpt(cfg.output_path, 20))[1][0])
    for key in ("f", "rho", "vel"):
        assert torch.equal(finals[0][key], finals[1][key]), key

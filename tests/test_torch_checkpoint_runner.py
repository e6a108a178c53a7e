"""The port's checkpoints and runner against the JAX package's.

- checkpoints (npz format 1): a round trip in float32 and bf16 bit for bit
  (bf16 members as uint16 bits tagged "__bf16", what the JAX writer
  writes), the carried "_ifsl" slabs left out, the async writer (a copy
  taken before it returns), `wait_pending`, `latest_checkpoint`; a
  JAX-written checkpoint converted by `convert.checkpoint_from_jax` loads
  in the port, and a port checkpoint converted by `checkpoint_to_jax`
  loads in JAX's `load_checkpoint`;
- the runner end to end (the port's versions of `tests/test_runner_e2e.py`
  :28, :53, :74, :117, :216): flow_* / surface_* files that decode with one
  `Level` entry per kept cell, the JAX runner's CSV schemas, a resumed run
  bit-equal to the uninterrupted one and truncating the CSVs, the force
  cadence independent of `diag_freq`, `--batch` isolating a failing case,
  `stability_action: abort` leaving a checkpoint, `--plan --device cpu`,
  the profiler trace;
- `forces.method: momentum_exchange` through both runners from one random
  state (a JAX checkpoint the port resumes from after
  `checkpoint_from_jax`), float32, 20 coarse steps: forces.csv within
  2e-5 x the sum of |link contribution| x force_scale per component (the
  float32 summation bound of `tests/test_torch_outputs.py` with 20 steps
  of float32 drift between the two packages' states).
"""

import csv
import dataclasses
import logging
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from open_ludwig_tpu import checkpoint as ckpt_jax
from open_ludwig_tpu import lattice as lat_jax
from open_ludwig_tpu.config import load_case_config as load_case_config_jax
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh as load_mesh_jax
from open_ludwig_tpu.io import csv_out as csv_jax
from open_ludwig_tpu.runner import solve_case as solve_case_jax
from open_ludwig_tpu.scaling import compute_domain_params as domain_params_jax

from open_ludwig_torch import checkpoint as ckpt
from open_ludwig_torch import checks, convert, runner
from open_ludwig_torch.cases import make_case_sphere
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.geometry import load_mesh
from open_ludwig_torch.io import vtk
from open_ludwig_torch.ops import forces
from open_ludwig_torch.scaling import compute_domain_params
from open_ludwig_torch.core.patch import build_patches

torch.set_num_threads(1)


def _edit_config(case_dir, fn):
    path = os.path.join(case_dir, "config.yaml")
    with open(path) as fh:
        cfgd = yaml.safe_load(fh)
    fn(cfgd)
    with open(path, "w") as fh:
        yaml.safe_dump(cfgd, fh)


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _random_port_states(levels, bf16, rng, slabs=False):
    out = []
    for p in levels:
        sh = tuple(p.interior)
        f = torch.from_numpy((0.01 * rng.standard_normal((27,) + sh)).astype(np.float32))
        st = {"f": f.to(torch.bfloat16) if bf16 else f + 0.05,
              "rho": torch.from_numpy((1 + 0.01 * rng.standard_normal(sh))
                                      .astype(np.float32)),
              "vel": torch.from_numpy((0.02 * rng.standard_normal((3,) + sh))
                                      .astype(np.float32))}
        if slabs:
            st["_ifsl"] = {"x": torch.zeros(3)}
        out.append(st)
    return out


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_states_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert set(sb) == {"f", "rho", "vel"}
        for key in ("f", "rho", "vel"):
            assert sa[key].dtype == sb[key].dtype, key
            assert torch.equal(_bits(sa[key]), _bits(sb[key])), key


@pytest.fixture(scope="module")
def sphere2_levels(tmp_path_factory):
    """A 2-level sphere's JAX levels (padded) and the port's."""
    d = str(tmp_path_factory.mktemp("levels"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=2,
                     ramp_steps=1, output_freq=100, diag_freq=100)
    cfg = load_case_config_jax(d)
    mesh = load_mesh_jax(cfg.stl_path, scale=cfg.stl_scale)
    params = domain_params_jax(cfg, mesh.min_bounds, mesh.max_bounds)
    levels_j = build_patches_jax(cfg, mesh, params)
    return levels_j, [convert.level_from_jax(p) for p in levels_j]


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoint_round_trip(sphere2_levels, tmp_path, bf16):
    _, levels = sphere2_levels
    states = _random_port_states(levels, bf16, np.random.default_rng(3), slabs=True)
    path = ckpt.save_checkpoint(str(tmp_path), 7, states)
    assert path == str(tmp_path / "ckpt_00000007.npz")
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        assert not any("_ifsl" in n for n in names)
        tag = "__bf16" if bf16 else ""
        assert f"L1_f{tag}.npy" in names and "L1_rho.npy" in names
        with zf.open(f"L0_f{tag}.npy") as fh:
            version = np.lib.format.read_magic(fh)
            shape, _, dtype = np.lib.format._read_array_header(fh, version)
    # the JAX writer's header: version 2.0, uint16 for bf16
    assert version == (2, 0) and shape == (27,) + tuple(levels[0].interior)
    assert dtype == (np.dtype("<u2") if bf16 else np.dtype("<f4"))
    step, loaded = ckpt.load_checkpoint(path)
    assert step == 7
    _assert_states_equal(states, loaded)
    # the other storage type is converted on request, the same one kept
    precision = "float32" if bf16 else "bfloat16"
    _, conv = ckpt.load_checkpoint(path, precision=precision)
    assert conv[0]["f"].dtype == (torch.float32 if bf16 else torch.bfloat16)
    _, same = ckpt.load_checkpoint(path, precision="bfloat16" if bf16 else "float32")
    _assert_states_equal(states, same)


def test_async_writer_and_latest(sphere2_levels, tmp_path):
    _, levels = sphere2_levels
    states = _random_port_states(levels, True, np.random.default_rng(4))
    want = [{k: v.clone() for k, v in st.items()} for st in states]
    d = str(tmp_path / "ck")
    p1 = ckpt.save_checkpoint(d, 10, states, async_write=True)
    # the run goes on writing its buffers: the checkpoint holds the copy
    for st in states:
        st["f"].zero_()
        st["rho"].add_(1.0)
    p2 = ckpt.save_checkpoint(d, 20, states, async_write=True)  # waits for p1
    assert os.path.isfile(p1)
    th = ckpt._pending
    ckpt.wait_pending()
    assert th is None or not th.is_alive()
    assert ckpt._pending is None
    assert ckpt.latest_checkpoint(d) == p2
    assert sorted(os.listdir(d)) == ["ckpt_00000010.npz", "ckpt_00000020.npz"]
    _, got = ckpt.load_checkpoint(p1)
    _assert_states_equal(want, got)
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_in_port(sphere2_levels, tmp_path, precision):
    levels_j, levels_p = sphere2_levels
    rng = np.random.default_rng(8)
    states_j = []
    for p in levels_j:
        f = (lat_jax.W[:, None, None, None] * (1 + 0.03 * rng.standard_normal(
            (27,) + p.padded))).astype(np.float32)
        states_j.append({
            "f": jnp.asarray(f - lat_jax.W[:, None, None, None]).astype(jnp.bfloat16)
            if precision == "bfloat16" else jnp.asarray(f),
            "rho": jnp.asarray(rng.standard_normal(p.padded).astype(np.float32)),
            "vel": jnp.asarray(rng.standard_normal((3,) + p.padded).astype(np.float32)),
        })
    pj = ckpt_jax.save_checkpoint(str(tmp_path / "jax"), 12, states_j)
    pp = convert.checkpoint_from_jax(pj, levels_j, str(tmp_path / "port"))
    step, got = ckpt.load_checkpoint(pp, precision=precision)
    assert step == 12
    want = [convert.state_from_jax({k: np.asarray(v) for k, v in s.items()}, p)
            for s, p in zip(states_j, levels_j)]
    _assert_states_equal(want, got)
    assert tuple(got[1]["f"].shape) == (27,) + tuple(levels_p[1].interior)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax(sphere2_levels, tmp_path, precision):
    levels_j, levels_p = sphere2_levels
    bf16 = precision == "bfloat16"
    states = _random_port_states(levels_p, bf16, np.random.default_rng(9))
    pp = ckpt.save_checkpoint(str(tmp_path / "port"), 30, states)
    pj = convert.checkpoint_to_jax(pp, levels_j, str(tmp_path / "jax"))
    # without `precision` JAX's loader keeps the stored bits (with it, it
    # re-encodes bf16 g through float32 f, which rounds g below w's ulp)
    step, got = ckpt_jax.load_checkpoint(pj)
    assert step == 30
    _, got_p = ckpt_jax.load_checkpoint(pj, precision=precision)
    assert [s["f"].dtype for s in got_p] == [s["f"].dtype for s in got]
    for st, sj, p in zip(states, got, levels_j):
        want = convert.state_to_jax(st, p)
        assert sj["f"].dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        for key in ("f", "rho", "vel"):
            arr = np.asarray(sj[key]).astype(np.float32)
            assert arr.shape == want[key].shape and np.array_equal(arr, want[key]), key


# ---- the runner end to end ----


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    """A 2-level bf16 sphere with momentum exchange, every output on:
    4 coarse steps, files and checkpoints every 2."""
    d = str(tmp_path_factory.mktemp("run2"))
    make_case_sphere(d, "1M", surface_resolution=8, num_levels=2, steps=4,
                     ramp_steps=2, output_freq=2, diag_freq=2, precision="bfloat16",
                     inlet_turbulence=0.02)
    _edit_config(d, lambda c: c["advanced"].setdefault("forces", {}).update(
        method="momentum_exchange"))
    cfg = load_case_config(d).with_overrides(checkpoint_freq=2)
    cfg = dataclasses.replace(cfg, output_fields=dataclasses.replace(
        cfg.output_fields, density=True, vorticity=True))
    assert cfg.force_method == "momentum_exchange"
    res = runner.solve_case(cfg, device="cpu")
    return cfg, res


def test_runner_writes_flow_and_surface_files(run2):
    cfg, res = run2
    out = cfg.output_path
    files = sorted(os.listdir(out))
    assert files == ["checkpoints", "convergence.csv", "flow_000002.vtu",
                     "flow_000004.vtu", "forces.csv", "surface_000002.vtu",
                     "surface_000004.vtu"], files
    assert [(k, s) for k, s, _, _ in res.outputs] == [
        ("flow", 2), ("surface", 2), ("checkpoint", 2),
        ("flow", 4), ("surface", 4), ("checkpoint", 4)]
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    levels = build_patches(cfg, mesh, compute_domain_params(
        cfg, mesh.min_bounds, mesh.max_bounds))
    # cells of level 1 under level 2 are not written
    c = levels[1]
    clo = np.asarray(c.lo) // 2 - np.asarray(levels[0].lo)
    chi = (np.asarray(c.lo) + np.asarray(c.interior)) // 2 - np.asarray(levels[0].lo)
    covered = int(np.prod(np.clip(chi, 0, levels[0].interior)
                          - np.clip(clo, 0, levels[0].interior)))
    kept = {1: levels[0].n_cells - covered, 2: levels[1].n_cells}
    for step in (2, 4):
        flow = vtk.read_vtu(os.path.join(out, f"flow_{step:06d}.vtu"))
        lv = flow["Level"]
        assert {k: int((lv == k).sum()) for k in (1, 2)} == kept
        assert len(lv) == sum(kept.values())
        for name in ("Density", "Velocity", "VelocityMagnitude", "Vorticity"):
            assert len(flow[name]) == len(lv) and np.isfinite(flow[name]).all(), name
        assert flow["Points"].dtype == np.float32
        surf = vtk.read_vtu(os.path.join(out, f"surface_{step:06d}.vtu"))
        assert len(surf["Pressure_Pa"]) == mesh.n_triangles
        assert np.isfinite(surf["Pressure_Pa"]).all()


def test_runner_csv_schemas_match_jax(run2):
    cfg, res = run2
    for fname, header in (("convergence.csv", csv_jax.CONVERGENCE_HEADER),
                          ("forces.csv", csv_jax.FORCES_HEADER)):
        with open(os.path.join(cfg.output_path, fname)) as fh:
            rows = list(csv.reader(fh))
        assert ",".join(rows[0]) == header, fname
        assert [int(r[0]) for r in rows[1:]] == [2, 4], fname
        assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[2:]), rows
    assert np.isfinite(res.final_forces.Cd) and res.final_forces.force_map is not None


def test_resume_is_bit_equal_and_truncates_csvs(run2):
    cfg, res = run2
    ck_dir = os.path.join(cfg.output_path, "checkpoints")
    _, full = ckpt.load_checkpoint(os.path.join(ck_dir, "ckpt_00000004.npz"))
    forces_full = _rows(os.path.join(cfg.output_path, "forces.csv"))
    # resume at 2 while the CSVs already hold step 4
    os.remove(os.path.join(ck_dir, "ckpt_00000004.npz"))
    res2 = runner.solve_case(cfg.with_overrides(checkpoint_resume=True), device="cpu")
    assert res2.resume_step == 2
    step, resumed = ckpt.load_checkpoint(os.path.join(ck_dir, "ckpt_00000004.npz"))
    assert step == 4
    _assert_states_equal(full, resumed)
    for fname in ("convergence.csv", "forces.csv"):
        steps = [int(r["Step"]) for r in _rows(os.path.join(cfg.output_path, fname))]
        assert steps == [2, 4], (fname, steps)
    assert _rows(os.path.join(cfg.output_path, "forces.csv")) == forces_full
    assert os.path.isfile(os.path.join(cfg.output_path, "flow_000002.vtu"))


def test_runner_accepts_ported_configs(run2):
    """momentum_exchange, checkpoint.freq > 0, checkpoint.resume (run
    above and in the tests beside this one) and layout: blocks
    (tests/test_torch_blocks_runner.py) pass the runner's check."""
    cfg = run2[0]
    for over in (dict(force_method="momentum_exchange"), dict(checkpoint_freq=10),
                 dict(checkpoint_resume=True), dict(layout="blocks")):
        runner.check_supported(dataclasses.replace(cfg, **over))


def _tiny_case(d, **over):
    opts = dict(surface_resolution=8, num_levels=1, steps=20, ramp_steps=10,
                output_freq=100, diag_freq=10, wake_enabled=False,
                boundary_method="bounce_back", wall_model=False)
    opts.update(over)
    make_case_sphere(d, "1M", **opts)


def test_mem_forces_csv_matches_jax_runner(tmp_path):
    """Both runners resume from one random float32 state (a JAX checkpoint;
    the port's through `convert.checkpoint_from_jax`) and run 20 coarse
    steps with momentum exchange, forces every 5 (its cadence apart from
    diagnostics every 10)."""
    d = str(tmp_path)
    _tiny_case(d)

    def edit(c):
        c["advanced"].setdefault("forces", {}).update(
            output_freq=5, method="momentum_exchange")
    _edit_config(d, edit)
    cfg_j = load_case_config_jax(d).with_overrides(output_dir="RJ",
                                                   checkpoint_resume=True)
    mesh = load_mesh_jax(cfg_j.stl_path, scale=cfg_j.stl_scale)
    params = domain_params_jax(cfg_j, mesh.min_bounds, mesh.max_bounds)
    levels_j = build_patches_jax(cfg_j, mesh, params)
    rng = np.random.default_rng(5)
    states_j = []
    for p in levels_j:
        f = (lat_jax.W[:, None, None, None] * (1 + 0.01 * rng.standard_normal(
            (27,) + p.padded))).astype(np.float32)
        rho = f.sum(0)
        vel = (np.einsum("kxyz,ck->cxyz", f, lat_jax.C) / rho).astype(np.float32)
        states_j.append({"f": jnp.asarray(f), "rho": jnp.asarray(rho),
                         "vel": jnp.asarray(vel)})
    pj = ckpt_jax.save_checkpoint(os.path.join(cfg_j.output_path, "checkpoints"),
                                  0, states_j)
    solve_case_jax(cfg_j)

    cfg = load_case_config(d).with_overrides(output_dir="RT", checkpoint_resume=True,
                                             checkpoint_freq=5)
    assert cfg.effective_force_output_freq == 5 and cfg.diag_freq == 10
    convert.checkpoint_from_jax(pj, levels_j, os.path.join(cfg.output_path,
                                                           "checkpoints"))
    res = runner.solve_case(cfg, device="cpu")
    assert res.resume_step == 0 and res.steps == 20
    rows_j = _rows(os.path.join(cfg_j.output_path, "forces.csv"))
    rows_t = _rows(os.path.join(cfg.output_path, "forces.csv"))
    assert [int(r["Step"]) for r in rows_t] == [5, 10, 15, 20]
    assert [int(r["Step"]) for r in rows_j] == [5, 10, 15, 20]
    conv = _rows(os.path.join(cfg.output_path, "convergence.csv"))
    assert [int(r["Step"]) for r in conv] == [10, 20]
    ctx = forces.make_mem_context(convert.level_from_jax(levels_j[-1]), params, mesh,
                                  g_storage=False)
    for rj, rt in zip(rows_j, rows_t):
        step = int(rt["Step"])
        _, st = ckpt.load_checkpoint(os.path.join(cfg.output_path, "checkpoints",
                                                  f"ckpt_{step:08d}.npz"))
        ref = checks.mem_float64(st[-1]["f"], ctx)
        bound = {"F": 2 * ref["F_bound"], "M": 2 * ref["M_bound"]}  # 2e-5 x sum|.|
        for kind, names in (("F", ("Fx_N", "Fy_N", "Fz_N")),
                            ("M", ("Mx_Nm", "My_Nm", "Mz_Nm"))):
            for i, name in enumerate(names):
                a, b = float(rj[name]), float(rt[name])
                # plus the CSV's 7 significant digits
                assert abs(a - b) <= bound[kind][i] + 1e-6 * abs(a), (step, name, a, b)
        assert abs(float(rt["Fx_N"])) > 10 * bound["F"][0]


def test_batch_isolates_failing_case(tmp_path):
    root = tmp_path / "CASES"
    _tiny_case(str(root / "good"), steps=2, diag_freq=100)
    (root / "broken").mkdir(parents=True)
    (root / "broken" / "config.yaml").write_text("basic: {}\n")
    batch = tmp_path / "cases_to_run.yaml"
    batch.write_text(yaml.safe_dump({"case_folders": ["broken", "good"]}))
    assert runner.main(["--batch", str(batch), str(root), "--device", "cpu"]) == 0
    assert (root / "good" / "RESULTS" / "convergence.csv").exists()
    assert runner.run_all_cases(str(root), str(batch), device="cpu") == ["broken"]
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(["--batch", str(batch), str(root)])


def test_stability_abort_leaves_checkpoint(tmp_path):
    """stability_action: abort saves the state, then raises (the JAX
    runner's behaviour; the reference only warns)."""
    d = str(tmp_path)
    _tiny_case(d, steps=200, ramp_steps=2, output_freq=1000, diag_freq=5)

    def edit(c):
        c["advanced"]["numerics"]["u_lattice"] = 0.4  # Ma ~ 0.7, no ramp
        c["advanced"].setdefault("diagnostics", {})["stability_action"] = "abort"
    _edit_config(d, edit)
    cfg = load_case_config(d)
    assert cfg.stability_action == "abort"
    with pytest.raises(RuntimeError, match="diverged"):
        runner.solve_case(cfg, device="cpu")
    ckpts = os.listdir(os.path.join(cfg.output_path, "checkpoints"))
    assert len(ckpts) == 1
    step, states = ckpt.load_checkpoint(os.path.join(cfg.output_path, "checkpoints",
                                                     ckpts[0]))
    assert 0 < step < 200 and step % 5 == 0


def test_plan_on_cpu_prints_report(tmp_path, caplog):
    d = str(tmp_path)
    _tiny_case(d)
    with caplog.at_level(logging.INFO, logger="open_ludwig_torch"):
        assert runner.main(["--plan", d, "--device", "cpu"]) == 0
    text = caplog.text
    assert "Device memory" in text and "total" in text and "[engine]" in text
    assert "capacity: not estimated on the CPU" in text
    assert not os.path.exists(os.path.join(d, "RESULTS"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.main(["--plan", d])


def test_capacity_formula_matches_report():
    """The capacity `plan_case` reports: the card's rule's capacity (the
    card's memory less its reserve) over a level's bytes a cell."""
    from open_ludwig_torch import memory

    n = 2**30
    for fb in (4, 2):
        resident, second = memory.level_bytes(n, fb, "k1")
        assert resident == (27 * fb + 16 + 9) * n and second == (27 * fb + 16) * n
        assert memory.bytes_per_cell(fb, "k1") == 2 * 27 * fb + 32 + 9
        # K5: a second rho and vel, and its edge buffer's bound (18 entries a
        # cell of every 8-row (bf16) or 16-row (float32) tile boundary and
        # 8-plane run boundary)
        edge = {2: 18 * 2 * (1 / 8 + 1 / 8), 4: 18 * 4 * (1 / 16 + 1 / 8)}[fb]
        assert memory.edge_bound_elems(2**20, fb) * fb == edge * 2**20
        assert memory.bytes_per_cell(fb, "inplace") == 27 * fb + 25 + 16 + edge
        per_card = 80 * 10**9 - memory.card_reserve(80 * 10**9)  # 4 GB reserved
        assert memory.level_capacity(per_card, fb, "k1") == int(
            76e9 / (2 * 27 * fb + 41))
    assert memory.card_capacity("cpu") is None


def test_profile_env_writes_trace(tmp_path, monkeypatch):
    d = str(tmp_path / "case")
    _tiny_case(d, steps=4, diag_freq=2, ramp_steps=2)
    monkeypatch.setenv("OPEN_LUDWIG_PROFILE", str(tmp_path / "prof"))
    runner.solve_case(load_case_config(d), device="cpu")
    assert os.listdir(str(tmp_path / "prof")) == ["trace_3_4.json"]

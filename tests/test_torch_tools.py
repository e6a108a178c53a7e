"""The port's validation and capacity tools (`open_ludwig_torch/tools/`).

- each of the eight counterparts of the JAX side's tools runs on
  `--device cpu` at a tiny size (N = 8-12, a few coarse steps) and prints
  or writes its schema; `validate_spheres --resume` continues from the
  case's latest checkpoint; `plan_216m --device cpu --res 12` reports a
  memory estimate within 10% of the port's `hbm_report_patches`;
  `big_shard_probe --device cpu` runs the row on 2 CPU slabs bit-equal to
  one device;
- without CUDA each raises when the card is asked for (the default);
- `window_stats` and `re10m_ci`'s CI equal the JAX tools' on one synthetic
  forces.csv (the JAX tools are imported here; the port's never import
  them).
"""

import csv
import importlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from open_ludwig_torch.io.csv_out import FORCES_HEADER
from open_ludwig_torch.tools import (big_shard_probe, mem_convergence, mem_probe,
                                     plan_216m, re10m_ci, validate_spheres,
                                     validate_wing, wing_cv_probe)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = (big_shard_probe, mem_convergence, mem_probe, plan_216m, re10m_ci,
         validate_spheres, validate_wing, wing_cv_probe)


@pytest.fixture
def jax_tools(monkeypatch):
    """The JAX side's tools/validate_spheres.py and re10m_ci.py as modules."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    vs = importlib.import_module("validate_spheres")
    ci = importlib.import_module("re10m_ci")
    return vs, ci


def _synthetic_forces(path, last=24000, every=200, seed=4):
    rng = np.random.default_rng(seed)
    cols = FORCES_HEADER.split(",")
    with open(path, "w") as fh:
        fh.write(FORCES_HEADER + "\n")
        for step in range(every, last + 1, every):
            vals = {c: f"{rng.standard_normal():.7e}" for c in cols}
            vals["Step"] = str(step)
            vals["Cd"] = f"{0.35 + 0.05 * rng.standard_normal():.7e}"
            fh.write(",".join(vals[c] for c in cols) + "\n")
    return str(path)


def test_window_stats_equals_jax(tmp_path, jax_tools):
    vs_jax, _ = jax_tools
    path = _synthetic_forces(tmp_path / "forces.csv")
    for last, window in ((24000, 2000), (14000, 2000), (24000, 16000), (5000, 300)):
        assert (validate_spheres.window_stats(path, last, window)
                == vs_jax.window_stats(path, last, window)), (last, window)
    assert validate_spheres.window_stats(path, 24000) == vs_jax.window_stats(path, 24000)
    assert {k: {q: v for q, v in r.items() if q != "case"}
            for k, r in validate_spheres.REGIMES.items()} == vs_jax.REGIMES


def test_re10m_ci_equals_jax(tmp_path, jax_tools, monkeypatch, capsys):
    """The JAX tool's main with its runs replaced by fixed (Cd, sd) and its
    r3 windows read from one synthetic forces.csv; the port's `t_ci` over
    the same samples and `r3_windows` over the same file print the same
    CI."""
    vs_jax, ci_jax = jax_tools
    path = _synthetic_forces(tmp_path / "forces.csv")
    fixed = {"_r1": (0.3412, 0.021), "_r2": (0.3187, 0.019), "_r3": (0.0, 0.0)}
    monkeypatch.setattr(ci_jax, "run_regime", lambda regime, tag, **kw: fixed[tag])
    monkeypatch.setattr(ci_jax, "window_stats",
                        lambda forces, last: vs_jax.window_stats(path, last))
    monkeypatch.setattr(sys, "argv", ["re10m_ci.py", "r1", "r2", "r3"])
    ci_jax.main()
    jax_line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("[RE10M CI]"))
    # r1 at the JAX tool's 12000 steps: r3's windows end at 14000..24000
    assert re10m_ci.r3_lasts(12000) == list(range(14000, 24001, 2000))
    wins = re10m_ci.r3_windows(path, re10m_ci.r3_lasts(12000))
    assert len(wins) == 6
    cds = [fixed["_r1"][0], fixed["_r2"][0], float(np.mean(wins))]
    mean, half, sdev, t95 = re10m_ci.t_ci(cds)
    assert jax_line.startswith(
        f"[RE10M CI] n=3 realization-samples: Cd {mean:.4f} +- {half:.4f} (95% "
        f"t-CI of the mean, t={t95}; sample sd {sdev:.4f})"), jax_line
    # past the run's end there is no window
    assert re10m_ci.r3_windows(path, [26000, 28000]) == []


def test_tools_need_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    calls = [(validate_spheres.main, ["1M", "--out", str(tmp_path)]),
             (re10m_ci.main, ["r1", "--out", str(tmp_path)]),
             (validate_wing.main, ["--out", str(tmp_path)]),
             (wing_cv_probe.main, ["--out", str(tmp_path)]),
             (mem_probe.main, ["--out", str(tmp_path)]),
             (mem_convergence.main, ["--cases", str(tmp_path),
                                     "--out", str(tmp_path / "m.json")]),
             (plan_216m.main, ["--cases", str(tmp_path)]),
             (big_shard_probe.main, ["--cases", str(tmp_path)])]
    assert {fn.__module__ for fn, _ in calls} == {m.__name__ for m in TOOLS}
    for fn, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argv)


def test_validate_spheres_cpu_and_resume(tmp_path, capsys):
    out = str(tmp_path)
    common = ["1M", "--device", "cpu", "--out", out, "--surface-resolution", "8"]
    (r,) = validate_spheres.main(common + ["--steps", "20"])
    assert r["resume_step"] == 0 and r["n"] == 10 and r["triangles"] == 5120
    assert set(r) >= {"cd", "sd", "cl", "stderr", "window_from", "dev_pct"}
    (r2,) = validate_spheres.main(common + ["--steps", "30", "--resume",
                                            "--window-from", "10"])
    assert r2["resume_step"] == 20 and r2["steps"] == 30 and r2["window_from"] == 10
    with open(r2["forces_csv"]) as fh:
        steps = [int(row["Step"]) for row in csv.DictReader(fh)]
    # the first run's rows kept, each step once, on to the new last step
    assert steps[:10] == list(range(2, 21, 2)) and steps == sorted(set(steps))
    assert steps[-1] == 30
    assert r2["n"] == sum(10 < s <= 30 for s in steps)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[VALIDATE 1M]")]
    assert len(lines) == 2
    assert re.search(r"Cd = [-0-9.]+ \+- [0-9.]+ \(Cl [-+0-9.]+, n=\d+, stderr "
                     r"[0-9.]+, window 10\+ of 30 steps, STL sphere.stl 5120 "
                     r"triangles\) \| ref 0.3780", lines[1]), lines[1]


@pytest.mark.parametrize("regime", ["10M", "1M"])
def test_re10m_ci_cpu(tmp_path, capsys, regime):
    samples = re10m_ci.main(["r1", "r2", "--device", "cpu", "--out", str(tmp_path),
                             "--steps", "6", "--surface-resolution", "8",
                             "--regime", regime, "--window-from", "2"])
    assert [s[0] for s in samples] == ["r1@6", "r2@6"]
    assert all(np.isfinite(s[1]) for s in samples)
    out = capsys.readouterr().out
    assert f"[RE10M CI] {regime}: n=2 realization-samples" in out
    assert f"[VALIDATE {regime}_r2]" in out and "window 2+ of 6 steps" in out


def test_re10m_ci_r3_runs_twice_r1(tmp_path, capsys):
    """r3 runs twice r1's steps from r1's configuration, so its windows
    start past r1's last step whatever `--steps` is (24,000 and 36,000
    give windows too)."""
    assert re10m_ci.r3_lasts(24000) == list(range(26000, 48001, 2000))
    assert re10m_ci.r3_lasts(36000)[0] == 38000 and re10m_ci.r3_lasts(36000)[-1] == 72000
    assert re10m_ci.r3_lasts(1000) == []  # shorter than one window
    samples = re10m_ci.main(["r3", "--device", "cpu", "--out", str(tmp_path),
                             "--steps", "4", "--surface-resolution", "8",
                             "--regime", "1M"])
    assert samples == []  # no 2000-step window in 8 steps
    assert "[VALIDATE 1M_r3]" in capsys.readouterr().out
    with open(tmp_path / "val_1M_r3" / "RESULTS" / "forces.csv") as fh:
        assert [int(r["Step"]) for r in csv.DictReader(fh)][-1] == 8


def test_validate_wing_cpu(tmp_path, capsys):
    rc = validate_wing.main(["--device", "cpu", "--out", str(tmp_path), "--res", "8",
                             "--steps", "10"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    for tag in ("[WING 0deg] Cl = ", "[WING 5deg] Cl = ", "[WING] dCl/dalpha = ",
                "[WING] Cl ordering: "):
        assert tag in out, out[-2000:]


def test_wing_cv_probe_cpu(tmp_path, capsys):
    fr, fm, F = wing_cv_probe.main(["--device", "cpu", "--out", str(tmp_path),
                                    "--res", "8", "--steps", "4"])
    assert np.isfinite(fr.Cd) and np.all(np.isfinite(F)) and F.shape == (3,)
    out = capsys.readouterr().out
    assert "[mapping] Cd=" in out and "[CV] F = " in out and "[mom-ex ]" in out


def test_mem_probe_cpu(tmp_path, capsys):
    fr, fm = mem_probe.main(["--device", "cpu", "--out", str(tmp_path), "--res", "8",
                             "--steps", "4", "--levels", "2"])
    assert fm is not None and np.isfinite(fm.Cd) and np.isfinite(fr.Cd)
    out = capsys.readouterr().out
    assert "[mapping] Cd=" in out and "[mom-ex ] Cd=" in out and "links" in out


def test_mem_convergence_cpu(tmp_path):
    path = tmp_path / "MEM_CONVERGENCE.json"
    rows = mem_convergence.main(["--device", "cpu", "--res", "8,10", "--base-steps",
                                 "10", "--cases", str(tmp_path), "--out", str(path)])
    with open(path) as fh:
        assert json.load(fh) == rows
    assert [r["res"] for r in rows] == [8, 10]
    assert [r["steps"] for r in rows] == [3, 4]
    for r in rows:
        assert set(r) >= {"n_samples", "n_links", "cd_mapped", "cd_mem", "cd_mem_std",
                          "cl_mem", "mem_vs_mapped_pct", "cd_reference"}
        assert r["n_links"] > 0 and r["n_samples"] >= 1


def test_plan_216m_cpu_estimate(tmp_path):
    """At N = 12 the planner's estimate (cells x bytes per cell) is within
    10% of the report's total, and K1 and K5 agree bit for bit."""
    out = plan_216m.main(["--device", "cpu", "--res", "12", "--steps", "4",
                          "--cases", str(tmp_path), "--out", str(tmp_path / "p.json")])
    with open(tmp_path / "p.json") as fh:
        assert json.load(fh) == out
    assert out["cells"] == int(np.prod(out["interior"])) and out["precision"] == "bfloat16"
    assert abs(out["estimate_bytes"] - out["report_bytes"]) <= 0.1 * out["report_bytes"]
    assert out["k1_k5_equal"] and out["finite"] and out["steps"] == 4
    assert "ms_per_coarse_step" not in out  # no device time on the CPU


def test_big_shard_probe_cpu(tmp_path):
    row = big_shard_probe.main(["--device", "cpu", "--res", "8", "--steps", "2",
                                "--cases", str(tmp_path)])
    assert row["equal_to_one_device"] and row["finite"] and row["slabs"] == 2
    assert row["precision"] == "bfloat16"

"""A whole run of the headline configuration (`sphere_re1m_bench`: 3 levels
with the wake box, wall model, bf16 g = f - w storage) cut to N = 8, on the
CPU: the set-up, a window, the check against the plain reference, held to
the configuration's own limits, as `test_a_run_on_the_cpu_is_correct` runs
the other two configurations."""

import os

import yaml

from lbm_bench import harness

CONFIG = os.path.join(harness.HERE, "configs", "sphere_re1m_bench")
TRAFFIC = {"call_steps": 2, "trace_calls": 1, "check_steps": 2, "perturb_rho": 0.001,
           "perturb_u": 0.05}


def test_a_run_of_the_cut_headline_on_the_cpu_is_correct(tmp_path):
    with open(os.path.join(CONFIG, "config.yaml")) as fh:
        doc = yaml.safe_load(fh)
    doc["basic"]["stl_file"] = os.path.join(harness.HERE, "geometry", "sphere.stl")
    doc["basic"]["surface_resolution"] = 8
    doc["advanced"]["high_re"]["min_coarse_blocks"] = 1
    with open(tmp_path / "config.yaml", "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    files = harness.cell_files(harness.load_spec(), "sphere_re1m_bench.steps")
    out = harness.run_case(str(tmp_path), TRAFFIC, files["limits"], 2 ** 31 + 5, 0.0,
                           False, "cpu", 0.0, say=lambda m: None)
    checks = out["checks"]
    assert set(checks) == {"start_gap", "end_gap"}
    assert all(c["ok"] for c in checks.values()), checks
    rec = out["record"]
    assert rec.store_bf16 and rec.wall_model and len(rec.levels) == 3
    line = harness.result_line(files, out, False)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == 2
    assert line["metrics"]["mlups_su"]["value"] > 0

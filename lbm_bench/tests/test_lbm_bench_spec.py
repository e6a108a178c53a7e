"""BENCHMARK.json against the contract's shape, and every file the harness
finds by name."""

import json
import os
import re

import pytest

from lbm_bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_and_paths():
    assert set(SPEC) == KEYS["top"]
    assert SPEC["paths"] == ["lbm_bench"]
    assert SPEC["command"] == ["python3", "lbm_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(harness.BENCHMARK) <= 64 * 1024


def test_entries_keys_and_names():
    names = []
    for kind, entries in (("config", SPEC["configs"]), ("workload", SPEC["workloads"]),
                          ("end_to_end", SPEC["end_to_end"]),
                          ("per_layer", SPEC["per_layer"])):
        for e in entries:
            extra = set(e) - KEYS[kind] - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                           else set())
            assert not extra and KEYS[kind] <= set(e), (kind, e["name"])
            assert NAME.match(e["name"])
            names.append((kind in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"mlups_su", "peak_reserved_gb", "sample_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
        assert callable(harness.reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for cell in m["workloads"]:
            movers = e2e[m["moves"]].get("workloads", cells)
            assert cell in movers
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"host preprocessing", "device under the batch runner and CUDA graphs",
                      "scheduler and ghost planes", "kernels", "forces and diagnostics"}
    for name in ("stream_collide_roofline", "idle_share", "step_mfu"):
        assert [m["unit"] for m in SPEC["per_layer"] if m["name"] == name] == ["%"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    files = harness.cell_files(SPEC, cell)
    assert files["cell"]["chips"] == 1
    assert os.path.isfile(os.path.join(files["case_dir"], "config.yaml"))
    assert os.path.isfile(os.path.join(files["case_dir"], "meta.json"))
    assert {"check_steps", "perturb_rho", "perturb_u"} <= set(files["traffic"])
    assert {"start_gap", "end_gap"} <= set(files["limits"]["limits"])
    if files["traffic"].get("forces_every"):
        assert "force_gap" in files["limits"]["limits"]
    names = {m["name"] for m in files["end_to_end"]}
    assert {"setup_s", "mlups_su"} <= names and files["per_layer"]


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configs(config):
    entry = [c for c in SPEC["configs"] if c["name"] == config][0]
    assert entry["file"].startswith("lbm_bench/configs/" + config + "/")
    with open(os.path.join(harness.ROOT, os.path.dirname(entry["file"]), "meta.json")) as fh:
        meta = json.load(fh)
    assert sorted(meta["reduced"]) == sorted(entry["reduced"])
    assert any(w["config"] == config for w in SPEC["workloads"])


def test_kernel_names():
    pats = harness.kernel_patterns()
    assert pats["stream_collide"].search("void (anonymous namespace)::stream_collide_kernel"
                                         "<float, false>(sc::Params)")
    assert pats["stream_collide"].search("void stream_collide_flat_kernel<__nv_bfloat16>()")
    assert not pats["stream_collide"].search("void link_kernel<float>(Link)")
    assert pats["bouzidi"].search("void (anonymous namespace)::link_kernel<float>(Link)")


def test_run_seconds_fit_a_full_check():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

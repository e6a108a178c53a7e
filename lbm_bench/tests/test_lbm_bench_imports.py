"""Nothing in lbm_bench imports jax or the JAX package; the reference imports
nothing of the program; the command refuses to run without a card or
without the program, printing no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from lbm_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "open_ludwig_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def _sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "open_ludwig_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "open_ludwig_tpu_like", sys)
    assert "open_ludwig_tpu_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _cmd(cwd):
    return subprocess.run(
        [sys.executable, "lbm_bench/run.py", "--workload", "sphere_re10m.run", "--seed",
         str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _cmd(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bare_checkout_no_result(tmp_path):
    shutil.copy(harness.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "lbm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cmd(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def test_a_cpu_run_loads_no_jax(tiny_case, tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from lbm_bench import harness\n"
        "t = {'call_steps': 2, 'forces_every': 2, 'stats_every': 2, 'check_steps': 1,"
        " 'perturb_rho': 1e-3, 'perturb_u': 0.05}\n"
        "lim = {'limits': {k: 1.0 for k in ('start_gap', 'end_gap', 'force_gap',"
        " 'stats_gap')}}\n"
        f"harness.run_case({tiny_case!r}, t, lim, 7, 0.0, False, 'cpu', 0.0,"
        " say=lambda m: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN and "open_ludwig_torch" in loaded


@pytest.mark.cuda
def test_trace_reads_the_card():
    """On a card: a profiled span of torch work reads as device operations
    launched in that span, busy time within the window."""
    import re
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lbm_bench import trace as tr
    x = torch.ones(1 << 20, device="cuda")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with tr.span("call", True):
        for _ in range(10):
            x = x * 1.0001 + 1.0
    torch.cuda.synchronize()
    prof.stop()
    rec = tr.read(prof, 1, 10, re.compile("elementwise"))
    assert rec is not None and 0 < rec.busy_ns <= rec.window_ns
    assert all(what == "step" for *_, what in rec.ops)

"""Storage codec and patch layout of the PyTorch port against the JAX
package, and the port's independence from jax.

- the bf16 g = f - w codec is bit-equal to `open_ludwig_tpu.ops.storage`;
- the port's unpadded patches equal the reference's interior fields, and
  its tight Bouzidi plan equals the reference's aligned one after
  embedding, for a 3-level sphere (surface_resolution 16, the smallest
  that keeps three levels);
- no source of the port (its tools included, nor chip_smoke.py) imports
  jax or the JAX package, at top level or inside a function (an AST
  scan), and importing
  every module of the port, building a case with its own `cases`, stepping
  it, running its Bouzidi probe and its bench's headline on the CPU loads
  neither (checked in a fresh interpreter).
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.ops import dense_step as ds_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops import storage

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_codec_bit_equal():
    """The inputs of test_precision.py::test_codec_roundtrip."""
    rng = np.random.default_rng(3)
    f = (lat.W[:, None, None, None] * (1 + 0.1 * rng.standard_normal(
        (27, 4, 8, 128)))).astype(np.float32)
    g_jax = np.asarray(storage_jax.encode_f(jnp.asarray(f), "bfloat16"))
    g = storage.encode_f(torch.as_tensor(f), "bfloat16")
    assert g.dtype == torch.bfloat16
    assert np.array_equal(g.view(torch.int16).numpy(), g_jax.view(np.int16))
    back_jax = np.asarray(storage_jax.decode_f(jnp.asarray(g_jax)))
    back = storage.decode_f(g)
    assert back.dtype == torch.float32
    assert np.array_equal(back.numpy(), back_jax)
    # float32 passes through untouched; the rest state encodes to zeros
    assert storage.encode_f(torch.as_tensor(f), "float32").dtype == torch.float32
    w = torch.as_tensor(lat.W).reshape(27, 1, 1, 1).expand(27, 2, 8, 4)
    assert not storage.encode_f(w, "bf16").float().any()
    with pytest.raises(ValueError):
        storage.normalize_precision("fp8")


@pytest.fixture(scope="module")
def sphere3(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sphere3"))
    make_case_sphere(d, "1M", surface_resolution=16, num_levels=3, steps=4,
                     ramp_steps=2, output_freq=100, diag_freq=100)
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    return cfg, mesh, params


def test_patches_equal_reference_interior(sphere3):
    cfg, mesh, params = sphere3
    ref = build_patches_jax(cfg, mesh, params)
    port = build_patches(cfg, mesh, params)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert p.padded == p.interior == r.interior
        assert (p.lo, p.face_bc, p.tau, p.dx) == (r.lo, r.face_bc, r.tau, r.dx)
        assert not hasattr(p, "flat_yz")  # no flat layout in the port
        for key in ("obstacle", "sponge", "wall_dist"):
            got = getattr(p, key)
            assert got.shape == tuple(p.interior)
            assert np.array_equal(got, convert.trim(getattr(r, key), r.interior)), key
        assert (p.bouzidi is None) == (r.bouzidi is None)
    # Bouzidi on the finest level: same links, the port's box unaligned
    plan_ref = ds_jax.build_bouzidi_dense_plan(ref[-1], cfg.q_min_threshold)
    plan = ds.build_bouzidi_dense_plan(port[-1], cfg.q_min_threshold)
    full_ref = convert.trim(convert.embed_S(
        {**plan_ref, "S": np.asarray(plan_ref["S"])}, ref[-1].padded),
        ref[-1].interior)
    assert np.array_equal(convert.embed_S(plan, port[-1].interior), full_ref)
    assert np.count_nonzero(plan["S"]) > 0


FORBIDDEN = ("jax", "jaxlib", "open_ludwig_tpu")


def _imported_roots(tree: ast.AST):
    """(line, module) of every import in `tree`, at any depth, including
    importlib.import_module / __import__ calls with a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_sources_never_import_jax():
    paths = sorted(glob.glob(os.path.join(REPO, "open_ludwig_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(paths) > 25, paths
    assert os.path.join(REPO, "open_ludwig_torch", "parallel", "patch_shard.py") in paths
    # the validation and capacity tools count as the port
    for tool in ("validate_spheres", "re10m_ci", "validate_wing", "wing_cv_probe",
                 "mem_probe", "mem_convergence", "plan_216m", "big_shard_probe"):
        assert os.path.join(REPO, "open_ludwig_torch", "tools", tool + ".py") in paths
    assert os.path.join(REPO, "open_ludwig_torch", "bench.py") in paths
    bad = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        bad += [(os.path.relpath(path, REPO), line, name)
                for line, name in _imported_roots(tree)
                if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_scan_finds_nested_imports():
    """The scan itself: imports inside functions and dynamic imports count."""
    src = ("def f():\n    import jax.numpy as jnp\n"
           "def g():\n    from open_ludwig_tpu.core import patch\n"
           "importlib.import_module('jaxlib')\nfrom . import lattice\n")
    names = [n for _, n in _imported_roots(ast.parse(src))]
    assert names == ["jax.numpy", "open_ludwig_tpu.core", "jaxlib"]


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter imports every module of the port, builds a
    2-level case with the port's own `cases`, runs two coarse steps, the
    Bouzidi probe and a tiny bench headline on the CPU; neither jax nor the
    JAX package may enter sys.modules."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys, torch
        torch.set_num_threads(1)
        import open_ludwig_torch
        mods = [m.name for m in pkgutil.walk_packages(open_ludwig_torch.__path__,
                                                      "open_ludwig_torch.")]
        for name in mods:
            importlib.import_module(name)
        assert "open_ludwig_torch.tools.probe_bz_encoding" in mods, mods
        assert "open_ludwig_torch.parallel.patch_shard" in mods, mods
        assert "open_ludwig_torch.tools.big_shard_probe" in mods, mods
        assert "open_ludwig_torch.bench" in mods, mods
        from open_ludwig_torch.cases import make_case_sphere
        from open_ludwig_torch.config import load_case_config
        from open_ludwig_torch.runner import solve_case
        from open_ludwig_torch.tools import probe_bz_encoding
        make_case_sphere({str(tmp_path)!r}, "1M", surface_resolution=8,
                         num_levels=2, steps=2, ramp_steps=1, output_freq=10,
                         diag_freq=1, precision="bfloat16",
                         inlet_turbulence=0.02)
        res = solve_case(load_case_config({str(tmp_path)!r}), device="cpu")
        assert res.steps == 2 and res.final_stats.rho_min > 0.5, res.final_stats
        out = probe_bz_encoding.main(["--device", "cpu", "--res", "8", "--levels",
                                      "1", "--n", "2", "--reps", "1"])
        assert out["links"] > 0 and out["max_abs_err"] < 2e-3, out
        from open_ludwig_torch import bench
        head = bench.headline("cpu", surface_resolution=8, num_levels=1, batch=2,
                              n_windows=1, builds=1)
        assert head["device"] == "cpu" and head["value_su"] > 0, head
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "open_ludwig_tpu"))
        assert not bad, bad
        print("NO_JAX_OK", len(mods))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout

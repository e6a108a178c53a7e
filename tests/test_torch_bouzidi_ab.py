"""K6 (the two-array Bouzidi encoding) of the PyTorch port against the JAX
package.

The CPU path of `cuda_step.bouzidi_ab` (`apply_bouzidi_ab_links`, over
the plan's link list; `tests/test_torch_bouzidi_links.py` holds it bit for
bit to the box sweep `apply_bouzidi_ab_plain`) is held:
  - with A and B in float32 on float32 f, to `make_bouzidi_pallas` in
    interpret mode on the same S: < 1e-6 (A = |S| and B = +-(1 - A) recover
    S exactly and sum to 1 within one ulp);
  - with A and B in bf16 on bf16 g-storage, to a jnp transcription of the
    probe's kernel body (tools/probe_bz_encoding.py:93-113, with `_shift2d`
    from open_ludwig_tpu.ops.pallas_step): < 2e-3 on decoded f.  The Pallas
    kernel itself is a closure inside that tool's `main()` that also
    allocates TPU scratch memory, so it can be neither imported nor run off
    a TPU; the transcription keeps its arithmetic line for line.
The probe's port (`open_ludwig_torch.tools.probe_bz_encoding`) runs on the
CPU and reports the JAX package's aligned box dims.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu.cases import make_case_sphere
from open_ludwig_tpu.config import load_case_config
from open_ludwig_tpu.core.patch import (
    BC_INLET,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from open_ludwig_tpu.core.patch import build_patches as build_patches_jax
from open_ludwig_tpu.domain.bouzidi import BouzidiData
from open_ludwig_tpu.geometry import load_mesh
from open_ludwig_tpu.ops import dense_step as ds_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.ops.pallas_step import _shift2d, make_bouzidi_pallas
from open_ludwig_tpu.scaling import compute_domain_params

from open_ludwig_torch import convert
from open_ludwig_torch.core.patch import build_patches
from open_ludwig_torch.ops import cuda_step
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.tools import probe_bz_encoding

torch.set_num_threads(1)

FACES = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)


def _levels(rng, edge_cells: bool):
    """(JAX level padded to the TPU tile, port level) with random boundary
    cells and q; with `edge_cells` some cells sit on the level's faces, so
    the box is clipped and the shifted read wraps."""
    X, Y, Z = 16, 14, 100
    nc = 60
    cells = np.stack([rng.integers(4, 12, nc), rng.integers(3, 11, nc),
                      rng.integers(30, 70, nc)], 1)
    if edge_cells:
        cells[:3] = [[0, 5, 40], [X - 1, 6, 50], [7, Y - 1, Z - 1]]
    cells = np.unique(cells, axis=0).astype(np.int32)
    q = np.zeros((len(cells), 27), np.float16)
    mask = rng.random((len(cells), 27)) < 0.3
    q[mask] = rng.uniform(0.05, 1.0, mask.sum()).astype(np.float16)
    q[:, 13] = 0
    bz = BouzidiData(cells[:, 0], cells[:, 1], cells[:, 2], q,
                     np.full((len(cells), 27), -1, np.int32))
    padded = (X, 16, 128)
    jp = PatchLevel(3, 0.1, 0.52, (0, 0, 0), (X, Y, Z), padded, FACES,
                    np.zeros(padded, bool), np.zeros(padded, np.float32),
                    np.full(padded, 100.0, np.float32), bouzidi=bz)
    return jp, convert.level_from_jax(jp)


def _f(jp, rng, store_bf16):
    f = jnp.asarray((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + jp.padded))).astype(np.float32))
    return storage_jax.encode_f(f, "bfloat16") if store_bf16 else f


def _ab_plan(plan, dtype):
    """The two-array plan of a port plan (numpy S), with its link list."""
    return ds.bouzidi_ab_plan(plan, dtype)


@pytest.mark.parametrize("edge_cells", [False, True])
def test_ab_encoding_recovers_S(edge_cells):
    jp, tp = _levels(np.random.default_rng(3), edge_cells)
    S = ds.build_bouzidi_dense_plan(tp, 0.001)["S"]
    A, B = ds.bouzidi_ab_from_S(S)
    assert A.dtype == B.dtype == np.float32
    assert np.array_equal(np.where(B < 0, -A, A), S)
    linked = A > 0
    assert np.array_equal(linked, S != 0) and not B[S == 1.0].any()
    # a + |b| = 1 to one ulp of 1 wherever a link is
    assert np.abs(A[linked] + np.abs(B[linked]) - 1.0).max() <= np.spacing(np.float32(1))


@pytest.mark.parametrize("edge_cells", [False, True])
def test_bouzidi_ab_plain_matches_pallas_interpret_f32(edge_cells):
    rng = np.random.default_rng(11)
    jp, tp = _levels(rng, edge_cells)
    pj = ds_jax.build_bouzidi_dense_plan(jp, 0.001)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    # the JAX box is tile-aligned, the port's tight: the same S once embedded
    assert np.array_equal(convert.embed_S(pt, tp.interior), convert.trim(
        convert.embed_S({**pj, "S": np.asarray(pj["S"])}, jp.padded), tp.interior))
    f = _f(jp, rng, store_bf16=False)
    want = np.asarray(make_bouzidi_pallas(pj, (27,) + jp.padded, f.dtype,
                                          interpret=True)(f))
    f_t = convert.to_tensor(convert.trim(np.asarray(f), tp.interior))
    got = cuda_step.bouzidi_ab(f_t, _ab_plan(pt, torch.float32))
    assert got.dtype == torch.float32 and got.data_ptr() != f_t.data_ptr()
    d = np.abs(got.numpy() - convert.trim(want, tp.interior)).max()
    assert d < 1e-6, d


def _probe_kernel_jnp(a_box, b_box, f, lo, dim, f_dtype):
    """The probe's Pallas kernel body (tools/probe_bz_encoding.py:93-113)
    on a whole level array: the box read once, each corrected row written
    back where A > 0."""
    lx, ly, lz = lo
    bx, by, bz = dim
    box = f[:, lx:lx + bx, ly:ly + by, lz:lz + bz]
    rows = []
    for j in range(27):
        if j == 13:
            rows.append(box[13])
            continue
        k = int(lat.OPP[j])
        cxk, cyk, czk = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        ff = box[k]
        if cxk:
            ff = jnp.roll(ff, cxk, axis=0)
        ff = _shift2d(ff, cyk, czk)
        a = a_box[k].astype(jnp.float32)
        b = b_box[k].astype(jnp.float32)
        other = jnp.where(b < 0, box[j].astype(jnp.float32), ff.astype(jnp.float32))
        val = (a * box[k].astype(jnp.float32) + jnp.abs(b) * other).astype(f_dtype)
        rows.append(jnp.where(a > 0, val, box[j]))
    return f.at[:, lx:lx + bx, ly:ly + by, lz:lz + bz].set(jnp.stack(rows))


@pytest.mark.parametrize("edge_cells", [False, True])
def test_bouzidi_ab_plain_matches_probe_kernel_bf16(edge_cells):
    rng = np.random.default_rng(12)
    jp, tp = _levels(rng, edge_cells)
    pj = ds_jax.build_bouzidi_dense_plan(jp, 0.001)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    g = _f(jp, rng, store_bf16=True)
    A, B = ds.bouzidi_ab_from_S(np.asarray(pj["S"]))
    want_g = _probe_kernel_jnp(jnp.asarray(A, jnp.bfloat16), jnp.asarray(B, jnp.bfloat16),
                               g, pj["lo"], pj["dim"], jnp.bfloat16)
    want = convert.trim(np.asarray(storage_jax.decode_f(want_g)), tp.interior)
    g_t = convert.to_tensor(convert.trim(np.asarray(g), tp.interior))
    got_t = cuda_step.bouzidi_ab(g_t, _ab_plan(pt, torch.bfloat16))
    assert got_t.dtype == torch.bfloat16
    d = np.abs(ds.decode_f(got_t).numpy() - want).max()
    assert d < 2e-3, d
    # slots without a link are untouched, bit for bit
    linked = np.zeros((27,) + tp.interior, bool)
    A_full = convert.embed_S({**pt, "S": np.abs(pt["S"])}, tp.interior)
    for j in range(27):
        linked[j] = A_full[int(lat.OPP[j])] > 0
    before = convert.to_numpy(g_t)
    assert np.array_equal(convert.to_numpy(got_t)[~linked], before[~linked])
    # and K2's plain version on the same S: the probe's bound
    k2 = ds.decode_f(ds.apply_bouzidi_dense(g_t, {**pt, "S": torch.as_tensor(pt["S"])}))
    assert (ds.decode_f(got_t) - k2).abs().max() < 2e-3


def test_bouzidi_ab_checks_its_inputs():
    jp, tp = _levels(np.random.default_rng(5), False)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    f = torch.zeros((27,) + tp.interior, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        cuda_step.bouzidi_ab(f, _ab_plan(pt, torch.float32))  # A, B not in f's dtype
    bad = _ab_plan(pt, torch.bfloat16)
    bad["B"] = bad["B"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        cuda_step.bouzidi_ab(f, bad)
    bad = _ab_plan(pt, torch.bfloat16)
    bad["links"] = {**bad["links"], "far": bad["links"]["far"].long()}
    with pytest.raises(ValueError, match="far"):
        cuda_step.bouzidi_ab(f, bad)
    cuda_step.reset_launches()
    cuda_step.bouzidi_ab(f, _ab_plan(pt, torch.bfloat16))
    assert cuda_step.LAUNCHES["bouzidi_ab"] == 0  # the CPU runs the plain version


def test_bouzidi_ab_plan_matches_encoding():
    jp, tp = _levels(np.random.default_rng(6), True)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    plan = {**pt, "S": torch.as_tensor(pt["S"])}
    got = ds.bouzidi_ab_plan(plan, torch.bfloat16)
    A, B = ds.bouzidi_ab_from_S(pt["S"])
    assert got["A"].dtype == torch.bfloat16
    assert torch.equal(got["A"], torch.as_tensor(A).to(torch.bfloat16))
    assert torch.equal(got["B"], torch.as_tensor(B).to(torch.bfloat16))
    assert got["links"]["A"].dtype == got["links"]["B"].dtype == torch.bfloat16


def test_probe_runs_on_cpu_and_reports_the_jax_box(tmp_path):
    """The probe's port at a small size on the CPU; its account of the JAX
    package's 8/128-aligned box equals the JAX plan built on the JAX
    package's own levels of the same case."""
    out = probe_bz_encoding.main(["--device", "cpu", "--res", "12", "--levels", "2",
                                  "--n", "2", "--reps", "2"])
    assert out["device"] == "cpu" and out["links"] > 0
    assert out["max_abs_err"] < probe_bz_encoding.ERR_TOL
    assert [len(v) for v in out["ms"].values()] == [2, 2]
    d = str(tmp_path / "ref")
    make_case_sphere(d, "1M", surface_resolution=12, num_levels=2, steps=400,
                     ramp_steps=200, output_freq=100000, diag_freq=100000,
                     wake_enabled=True, precision="bfloat16")
    cfg = load_case_config(d)
    mesh = load_mesh(cfg.stl_path, scale=cfg.stl_scale)
    params = compute_domain_params(cfg, mesh.min_bounds, mesh.max_bounds)
    ref = build_patches_jax(dataclasses.replace(cfg, flat_coarse="off"), mesh, params)
    plan_j = ds_jax.build_bouzidi_dense_plan(ref[-1], cfg.q_min_threshold)
    port = build_patches(cfg, mesh, params)
    assert out["ref_dim"] == probe_bz_encoding.ref_box_dim(port[-1]) == tuple(plan_j["dim"])
    assert out["dim"] == tuple(ds.build_bouzidi_dense_plan(port[-1], cfg.q_min_threshold)["dim"])
    assert out["level"] == tuple(port[-1].interior)

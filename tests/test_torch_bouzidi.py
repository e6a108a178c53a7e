"""K2 (Bouzidi) of the PyTorch port against the JAX package.

The port's tight-box plan must equal the JAX package's tile-aligned plan
once both are embedded into full-level arrays, and the plain correction
(the CPU path of `open_ludwig_torch.ops.cuda_step.bouzidi`) must match
`apply_bouzidi_dense` and the Pallas kernel in interpret mode: < 1e-6 in
float32, < 2e-3 on bf16 g-storage, untouched slots bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_ludwig_tpu import lattice as lat
from open_ludwig_tpu.core.patch import BC_INLET, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel
from open_ludwig_tpu.domain.bouzidi import BouzidiData
from open_ludwig_tpu.ops import dense_step as ds_jax
from open_ludwig_tpu.ops import storage as storage_jax
from open_ludwig_tpu.ops.pallas_step import make_bouzidi_pallas

from open_ludwig_torch import convert
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops.cuda_step import bouzidi

torch.set_num_threads(1)

FACES = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)


def level_pair(rng, edge_cells: bool):
    """Random boundary cells with random q; with `edge_cells` some sit on
    the level's faces, so the box is clipped and x_ff falls outside."""
    X, Y, Z = 16, 16, 120
    nc = 60
    cells = np.stack([
        rng.integers(4, 12, nc), rng.integers(4, 12, nc), rng.integers(40, 80, nc),
    ], 1)
    if edge_cells:
        cells[:3] = [[0, 5, 50], [X - 1, 6, 60], [7, Y - 1, Z - 1]]
    cells = np.unique(cells, axis=0).astype(np.int32)
    q = np.zeros((len(cells), 27), np.float16)
    mask = rng.random((len(cells), 27)) < 0.3
    q[mask] = rng.uniform(0.05, 1.0, mask.sum()).astype(np.float16)
    q[:, 13] = 0
    bz = BouzidiData(cells[:, 0], cells[:, 1], cells[:, 2], q,
                     np.full((len(cells), 27), -1, np.int32))
    padded = (X, Y, 128)
    jp = PatchLevel(3, 0.1, 0.52, (0, 0, 0), (X, Y, Z), padded, FACES,
                    np.zeros(padded, bool), np.zeros(padded, np.float32),
                    np.full(padded, 100.0, np.float32), bouzidi=bz)
    tp = dataclasses.replace(jp, padded=(X, Y, Z))
    return jp, tp


@pytest.mark.parametrize("edge_cells", [False, True])
def test_bouzidi_plan_matches_jax_after_embedding(edge_cells):
    jp, tp = level_pair(np.random.default_rng(7), edge_cells)
    pj = ds_jax.build_bouzidi_dense_plan(jp, 0.001)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    full_j = convert.trim(convert.embed_S(
        {**pj, "S": np.asarray(pj["S"])}, jp.padded), tp.interior)
    assert np.array_equal(convert.embed_S(pt, tp.interior), full_j)
    # the port's box is the tight one: never larger than the JAX box
    assert all(a <= b for a, b in zip(pt["dim"], pj["dim"]))


def _inputs(jp, rng, store_bf16):
    f = jnp.asarray((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + jp.padded))).astype(np.float32))
    return storage_jax.encode_f(f, "bfloat16") if store_bf16 else f


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edge_cells", [False, True])
def test_bouzidi_plain_matches_jax(edge_cells, store_bf16):
    rng = np.random.default_rng(8)
    jp, tp = level_pair(rng, edge_cells)
    pj = ds_jax.build_bouzidi_dense_plan(jp, 0.001)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    pt = {**pt, "S": torch.as_tensor(pt["S"])}
    f = _inputs(jp, rng, store_bf16)
    want = np.asarray(storage_jax.decode_f(ds_jax.apply_bouzidi_dense(f, pj)))
    f_t = convert.to_tensor(convert.trim(np.asarray(f), tp.interior))
    got_t = bouzidi(f_t.clone(), pt)
    assert got_t.dtype == f_t.dtype
    got = ds.decode_f(got_t).numpy()
    d = np.abs(got - convert.trim(want, tp.interior)).max()
    assert d < (2e-3 if store_bf16 else 1e-6), d
    # slots without a link are untouched, bit for bit
    S_full = convert.embed_S(pt, tp.interior)
    linked = np.zeros(S_full.shape, bool)
    for j in range(27):
        linked[j] = S_full[int(lat.OPP[j])] != 0
    before = convert.to_numpy(f_t)
    assert np.array_equal(convert.to_numpy(got_t)[~linked], before[~linked])


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_bouzidi_plain_matches_pallas_interpret(store_bf16):
    rng = np.random.default_rng(9)
    jp, tp = level_pair(rng, edge_cells=False)
    pj = ds_jax.build_bouzidi_dense_plan(jp, 0.001)
    pt = ds.build_bouzidi_dense_plan(tp, 0.001)
    pt = {**pt, "S": torch.as_tensor(pt["S"])}
    f = _inputs(jp, rng, store_bf16)
    kern = make_bouzidi_pallas(pj, (27,) + jp.padded, f.dtype, interpret=True)
    want = np.asarray(storage_jax.decode_f(kern(f)))
    got = ds.decode_f(bouzidi(
        convert.to_tensor(convert.trim(np.asarray(f), tp.interior)), pt)).numpy()
    d = np.abs(got - convert.trim(want, tp.interior)).max()
    # bf16: the Pallas kernel also rounds S to bf16 (pallas_step.py:158-163)
    assert d < (2e-3 if store_bf16 else 1e-6), d

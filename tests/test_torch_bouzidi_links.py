"""K2's link list (`dense_step.bouzidi_links`) and its plain version
(`apply_bouzidi_links`) against the box sweep the JAX package's kernel
performs (`apply_bouzidi_dense`); K6's link list of the two-array encoding
(`bouzidi_ab_links`, carried by `bouzidi_ab_plan`) and its plain version
(`apply_bouzidi_ab_links`) against its box sweep (`apply_bouzidi_ab_plain`)
the same way.

The list must hold exactly the plan's S (one entry per linked slot, sorted
by slot, then by cell, every read where the box sweep reads it, the wrap
inside the box included), and the correction over it must equal the box
sweep bit for bit, float32 and bf16, on the bench case's finest level and
on a synthetic box with wrapped reads, a cell linked in opposite
directions and a two-cell gap where one link reads a slot another writes.
"""

import os

import numpy as np
import pytest
import torch

from open_ludwig_torch import checks
from open_ludwig_torch import lattice as lat
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops import storage
from open_ludwig_torch.ops.cuda_step import bouzidi, bouzidi_ab

torch.set_num_threads(1)

LEVEL = (9, 8, 12)
LO = (1, 2, 3)
DIM = (6, 5, 7)


def _k(cx, cy, cz):
    return (cx + 1) + 3 * (cy + 1) + 9 * (cz + 1)


def synthetic_plan():
    """A box of random links plus three hand-placed hazards (box indices):
    a wrapped read at the box's faces, a cell linked in opposite directions
    (self and far), and a two-cell gap along x whose links point at each
    other, so that one link's far read is the slot the other writes."""
    rng = np.random.default_rng(11)
    S = np.zeros((27,) + DIM, np.float32)
    mask = rng.random(S.shape) < 0.15
    vals = rng.uniform(0.05, 1.0, mask.sum()).astype(np.float32)
    S[mask] = np.where(rng.random(mask.sum()) < 0.5, -vals, vals)
    S[13] = 0
    # wrapped: cell (0, 0, 0) links along c = (-1, -1, -1), far read at
    # cell - c_k wrapped to (1, 1, 1); cell (5, 4, 6) along +c wraps too
    S[_k(-1, -1, -1), 0, 0, 0] = 0.4
    S[_k(1, 1, 1), 5, 4, 6] = 0.35
    # opposite directions at one cell: far along +x, self along -x
    S[_k(1, 0, 0), 3, 2, 3] = 0.3
    S[_k(-1, 0, 0), 3, 2, 3] = -0.7
    # the gap: A = (2, 3, 1) links along k = +x (far read f_k at A - c_k =
    # B = (1, 3, 1)), and B links along opp(k), which writes slot k at B
    S[_k(1, 0, 0), 2, 3, 1] = 0.25
    S[_k(-1, 0, 0), 1, 3, 1] = 0.45
    return {"lo": LO, "dim": DIM, "level": LEVEL, "S": S,
            "links": ds.bouzidi_links(S, LO, LEVEL)}


@pytest.fixture(scope="module")
def bench_plan(tmp_path_factory):
    """The bench case's finest level (sphere Re~1M, 3 levels + wake, as
    chip_smoke.py builds it) at a small surface_resolution, and its plan."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    cfg, _, _, levels = checks.bench_case(os.path.join(tmp, "b"), surface_resolution=10)
    plan = ds.build_bouzidi_dense_plan(levels[-1], cfg.q_min_threshold)
    assert plan is not None
    return levels[-1], plan


def _plans(bench_plan):
    return {"synthetic": synthetic_plan(), "bench": bench_plan[1]}


def expand(plan):
    """S rebuilt from the link list, and each link's far read checked."""
    links = plan["links"]
    X, Y, Z = plan["level"]
    lx, ly, lz = plan["lo"]
    bx, by, bz = plan["dim"]
    S = np.zeros((27,) + tuple(plan["dim"]), np.float32)
    cell = links["cell"].astype(np.int64)
    x, r = np.divmod(cell, Y * Z)
    y, z = np.divmod(r, Z)
    j = (links["code"] & 31).astype(np.int64)
    k = 26 - j
    self_ = (links["code"] & ds.SELF_LINK) != 0
    S[k, x - lx, y - ly, z - lz] = np.where(self_, -links["a"], links["a"])
    # far reads at cell - c_k wrapped inside the box, self reads at the cell
    fx = (x - lx - lat.C_X[k]) % bx + lx
    fy = (y - ly - lat.C_Y[k]) % by + ly
    fz = (z - lz - lat.C_Z[k]) % bz + lz
    far = (fx * Y + fy) * Z + fz
    assert np.array_equal(links["src"], np.where(self_, cell, far))
    return S


@pytest.mark.parametrize("which", ["synthetic", "bench"])
def test_links_expand_to_S(bench_plan, which):
    plan = _plans(bench_plan)[which]
    links = plan["links"]
    assert links["cell"].dtype == np.int32 and links["src"].dtype == np.int32
    assert links["code"].dtype == np.uint8 and links["a"].dtype == np.float32
    assert len(links["a"]) == np.count_nonzero(plan["S"])
    assert np.array_equal(expand(plan), plan["S"])
    # sorted by slot, then by cell
    order = np.lexsort((links["cell"], links["code"] & 31))
    assert np.array_equal(order, np.arange(len(order)))


def test_synthetic_plan_has_its_hazards():
    """The fixture's hazards are in the list: some far read wraps, and some
    link reads a slot that another link writes."""
    plan = synthetic_plan()
    links = plan["links"]
    N = int(np.prod(LEVEL))
    j = (links["code"] & 31).astype(np.int64)
    self_ = (links["code"] & ds.SELF_LINK) != 0
    oslot = np.where(self_, j, 26 - j)
    reads = set((26 - j) * N + links["cell"]) | set(oslot * N + links["src"])
    writes = set(j * N + links["cell"])
    assert reads & writes
    X, Y, Z = LEVEL
    cell, src = links["cell"][~self_], links["src"][~self_]
    k = 26 - j[~self_]
    unwrapped = cell - ((lat.C_X[k] * Y + lat.C_Y[k]) * Z + lat.C_Z[k])
    assert (src != unwrapped).any()


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("which", ["synthetic", "bench"])
def test_links_plain_equals_box_sweep(bench_plan, which, store_bf16):
    plan = _plans(bench_plan)[which]
    plan = {**plan, "S": torch.as_tensor(plan["S"])}
    rng = np.random.default_rng(3)
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + tuple(plan["level"])))).astype(np.float32))
    if store_bf16:
        f = storage.encode_f(f, storage.STORE_BF16)
    want = ds.apply_bouzidi_dense(f, plan)
    got = ds.apply_bouzidi_links(f, plan)
    assert got.dtype == f.dtype
    assert torch.equal(got, want)
    assert not torch.equal(got, f)
    # the wrapper's CPU path is the link version
    assert torch.equal(bouzidi(f.clone(), plan), want)


def test_device_plan_holds_links_and_scratch():
    plan = ds.bouzidi_plan_to(synthetic_plan(), "cpu")
    links = plan["links"]
    n = len(links["a"])
    assert isinstance(plan["S"], torch.Tensor)
    for key, dtype in (("cell", torch.int32), ("code", torch.uint8),
                       ("src", torch.int32), ("a", torch.float32),
                       ("scratch", torch.float32)):
        assert links[key].dtype == dtype and links[key].shape == (n,)
    assert ds.bouzidi_plan_to(None, "cpu") is None


def test_plan_without_links_is_none(bench_plan):
    """A level whose q are all outside (q_min, 1] has boundary cells but
    no link: no plan, as for a level without boundary cells."""
    level, _ = bench_plan
    assert ds.build_bouzidi_dense_plan(level, q_min=2.0) is None


# ---- K6: the two-array encoding over its own link list ----

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def expand_ab(plan):
    """The A and B boxes rebuilt from K6's link list, and each link's far
    read checked (cell - c_k wrapped inside the box, whatever B's sign)."""
    links = {key: np.asarray(plan["links"][key]) for key in ("cell", "j", "far")}
    X, Y, Z = plan["level"]
    lx, ly, lz = plan["lo"]
    bx, by, bz = plan["dim"]
    A = np.zeros((27,) + tuple(plan["dim"]), np.float32)
    B = np.zeros_like(A)
    cell = links["cell"].astype(np.int64)
    x, r = np.divmod(cell, Y * Z)
    y, z = np.divmod(r, Z)
    k = 26 - links["j"].astype(np.int64)
    A[k, x - lx, y - ly, z - lz] = torch.as_tensor(plan["links"]["A"]).float().numpy()
    B[k, x - lx, y - ly, z - lz] = torch.as_tensor(plan["links"]["B"]).float().numpy()
    fx = (x - lx - lat.C_X[k]) % bx + lx
    fy = (y - ly - lat.C_Y[k]) % by + ly
    fz = (z - lz - lat.C_Z[k]) % bz + lz
    assert np.array_equal(links["far"], (fx * Y + fy) * Z + fz)
    order = np.lexsort((links["cell"], links["j"]))
    assert np.array_equal(order, np.arange(len(order)))
    return A, B


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["synthetic", "bench"])
def test_ab_links_expand_to_A_and_B(bench_plan, which, dtype):
    plan = ds.bouzidi_ab_plan(_plans(bench_plan)[which], DTYPES[dtype])
    links = plan["links"]
    assert links["cell"].dtype == links["far"].dtype == torch.int32
    assert links["j"].dtype == torch.uint8
    assert links["A"].dtype == links["B"].dtype == DTYPES[dtype]
    assert links["scratch"].dtype == torch.float32
    A, B = expand_ab(plan)
    assert np.array_equal(A, plan["A"].float().numpy())
    assert np.array_equal(B, plan["B"].float().numpy())
    # one link per linked slot: the slots of S, A > 0 in the storage dtype
    assert len(links["cell"]) == np.count_nonzero(_plans(bench_plan)[which]["S"])
    assert (links["A"].float() > 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["synthetic", "bench"])
def test_ab_links_plain_equals_box_sweep(bench_plan, which, dtype):
    plan = ds.bouzidi_ab_plan(_plans(bench_plan)[which], DTYPES[dtype])
    rng = np.random.default_rng(5)
    f = torch.as_tensor((lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + tuple(plan["level"])))).astype(np.float32))
    if dtype == "bf16":
        f = storage.encode_f(f, storage.STORE_BF16)
    want = ds.apply_bouzidi_ab_plain(f, plan)
    got = ds.apply_bouzidi_ab_links(f, plan)
    assert got.dtype == f.dtype
    assert torch.equal(got, want)
    assert not torch.equal(got, f)
    # the wrapper's CPU path is the link version
    assert torch.equal(bouzidi_ab(f.clone(), plan), want)

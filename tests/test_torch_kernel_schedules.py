"""The schedules of the PyTorch port's CUDA kernels, modelled on the CPU.

A CUDA kernel cannot run without a card, but what decides whether it is
right (besides the per-cell arithmetic, which the plain versions hold
against the JAX package) is where each value is read from and when:

- the kernels' pull (`csrc/lbm_cell.cuh`: every slot loaded from its source
  clamped into the level, then the face slots overwritten) as a plain-torch
  model, the plain step with `_shift_clamped` for its shift, equal to the
  plain step exactly on levels with every face type, interfaces included;
- K5's region layout (`ops/inplace_layout.py`, which the wrapper uses and
  `csrc/stream_collide_inplace.cu` mirrors): tile rows, chunk cells, run
  length, edge-buffer element counts and offsets;
- K5's schedule emulated with numpy on one buffer, in place: the edge copy,
  then the regions in a shuffled order, each walking its z-chunks and, inside
  a chunk, marching along x, every plane read (from the edge buffer, the
  plane save, the column save or f itself, as the kernel chooses) before it
  is written.  The values so pulled, through the plain collision, equal
  `dense_stream_collide` exactly;
- K3's ring protocol (`csrc/fused_pair.cu`: four A-planes, a "full" and a
  "free" barrier per slot), written out here as the events each side
  performs: producers and consumers stepped in random interleavings never
  read a plane that is not in the ring, never overwrite one still needed,
  and leave no barrier half counted.
"""

import numpy as np
import pytest
import torch

from open_ludwig_torch import lattice as lat
from open_ludwig_torch.core.patch import (
    BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_MIRROR_Z, BC_OUTLET, PatchLevel,
)
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops import inplace_layout as il
from open_ludwig_torch.ops import storage

torch.set_num_threads(1)

DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
FACES = {
    "domain": DOMAIN,
    "interfaces": (BC_INTERFACE,) * 6,
    "inlet-mix": (BC_INLET, BC_INTERFACE, BC_MIRROR_Y, BC_INTERFACE, BC_MIRROR_Z,
                  BC_INTERFACE),
    "outlet-mix": (BC_INTERFACE, BC_OUTLET, BC_INTERFACE, BC_MIRROR_Y,
                   BC_INTERFACE, BC_MIRROR_Z),
}
KW = dict(c_wale=0.5, nu_sgs_background=5e-4, inlet_turbulence=0.02,
          wall_model=True, sponge_blend=True)


def _level(interior, face_bc, rng):
    X, Y, Z = interior
    obstacle = np.zeros(interior, bool)
    obstacle[X // 3:X // 3 + 2, Y // 3:Y // 3 + 2, Z // 3:Z // 3 + 3] = True
    sponge = np.zeros(interior, np.float32)
    sponge[-3:] = np.linspace(0.1, 0.6, 3, dtype=np.float32)[:, None, None]
    wall = np.full(interior, 100.0, np.float32)
    wall[max(X // 3 - 1, 0), Y // 3, Z // 3] = 1.2
    patch = PatchLevel(2, 0.05, 0.53, (10, 12, 14), tuple(interior),
                       tuple(face_bc), obstacle, sponge, wall)
    static = {"obstacle": torch.as_tensor(obstacle),
              "sponge": torch.as_tensor(sponge),
              "wall_dist": torch.as_tensor(wall)}
    return patch, static


def _inputs(patch, rng, store_bf16):
    sh = tuple(patch.interior)
    f = torch.as_tensor((lat.W[:, None, None, None] * (
        1 + 0.05 * rng.standard_normal((27,) + sh))).astype(np.float32))
    if store_bf16:  # the values a bf16 g-buffer holds
        f = storage.decode_f(storage.encode_f(f, storage.STORE_BF16))
    vel = torch.as_tensor((0.02 * rng.standard_normal((3,) + sh)).astype(np.float32))
    iface = {}  # pre-shifted float32 f-space planes, as the steps read them
    for fc in range(6):
        if patch.face_bc[fc] == BC_INTERFACE:
            a, b = (sh[t] for t in range(3) if t != fc // 2)
            iface[fc] = torch.as_tensor((lat.W[:, None, None] * (
                1 + 0.03 * rng.standard_normal((27, a, b)))).astype(np.float32))
    return f, vel, iface


def _shift_clamped(a, cx, cy, cz):
    """out[..., x, y, z] = a[..., x', y', z'] with (x', y', z') = (x - cx,
    y - cy, z - cz) clamped into the level: the kernels' pull (`neighbours`
    in csrc/lbm_cell.cuh), which loads every slot from a cell of the level
    and leaves the cells beyond a face to the boundary masks."""
    for dim, c in ((-3, cx), (-2, cy), (-1, cz)):
        if c:
            n = a.shape[dim]
            idx = (torch.arange(n) - c).clamp_(0, n - 1)
            a = a.index_select(dim, idx)
    return a


@pytest.mark.parametrize("faces", list(FACES))
@pytest.mark.parametrize("interior", [(6, 7, 9), (3, 4, 5)], ids=["6x7x9", "3x4x5"])
def test_clamped_pull_model_equals_plain_step(rng, interior, faces):
    """Load clamped, then overwrite the face slots: the plain step exactly,
    on inlet, outlet, mirror and interface faces."""
    patch, static = _level(interior, FACES[faces], rng)
    f, vel, iface = _inputs(patch, rng, False)
    want = ds.dense_stream_collide(f, vel, 0.04, 9, static, patch, iface=iface, **KW)
    got = ds._stream_collide(_shift_clamped, f, vel, 0.04, 9, static, patch,
                             iface=iface, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shift_clamped_is_the_clamped_source(rng):
    a = torch.as_tensor(rng.standard_normal((2, 4, 5, 6)).astype(np.float32))
    for cx, cy, cz in ((1, 0, 0), (-1, 1, 0), (0, -1, 1), (1, 1, -1)):
        out = _shift_clamped(a, cx, cy, cz)
        for x, y, z in ((0, 0, 0), (3, 4, 5), (2, 1, 3), (0, 4, 2)):
            src = (min(max(x - cx, 0), 3), min(max(y - cy, 0), 4),
                   min(max(z - cz, 0), 5))
            assert torch.equal(out[:, x, y, z], a[(slice(None),) + src])


# ---- K5: layout ----


@pytest.mark.parametrize("elem_bytes,chunk,ty", [(2, 64, 8), (4, 32, 16)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(432, 384, 384), (232, 216, 216), (64, 56, 56),
                                   (7, 5, 3)])
def test_inplace_layout_counts_and_offsets(shape, elem_bytes, chunk, ty):
    X, Y, Z = shape
    lay = il.inplace_layout(X, Y, Z, 132, elem_bytes)
    assert (lay["chunk"], lay["ty"]) == (chunk, ty)
    assert lay["chunk"] * elem_bytes == il.ROW_BYTES
    assert lay["chunk"] * lay["ty"] == il.THREADS
    xr, nr, nty = lay["xr"], lay["nr"], lay["nty"]
    assert 1 <= xr <= il.MAX_RUN and (nr - 1) * xr < X <= nr * xr
    assert (nty - 1) * ty < Y <= nty * ty
    if X >= il.MIN_RUN:
        assert xr >= il.MIN_RUN
    assert lay["nx"] == 2 * (nr - 1) * 9 * Y * Z
    assert lay["ny"] == 2 * (nty - 1) * 9 * X * Z
    assert lay["edge_elems"] == lay["nx"] + lay["ny"]
    # plane save [2][9][ty * chunk] + column save [2][9][xr][ty]
    assert lay["smem_elems"] == 18 * ty * chunk + 18 * xr * ty
    # two blocks of the largest layout fit an SM's 227 KB of shared memory
    assert 2 * lay["smem_elems"] * elem_bytes <= 232448


def test_inplace_layout_row_at_full_size():
    """The 63.7M-cell bf16 row: 4 blocks per SM, an edge buffer under 10%
    of f (the wrapper allocates it above the state)."""
    lay = il.inplace_layout(432, 384, 384, 132, 2)
    assert lay["nr"] * lay["nty"] >= 4 * 132
    assert lay["edge_elems"] < 0.10 * 27 * 432 * 384 * 384
    with pytest.raises(ValueError):
        il.inplace_layout(432, 384, 384, 132, 3)
    with pytest.raises(ValueError):
        il.inplace_layout(0, 384, 384, 132, 2)


def test_edge_slot_sets():
    """kx / ky list the 9 slots that stream up (c = +1) or down across an x
    / y boundary, in the order the edge buffer stores them."""
    for fn, c in ((il.kx, lat.C_X), (il.ky, lat.C_Y)):
        for up in (True, False):
            ks = [fn(j, up) for j in range(9)]
            assert ks == sorted(k for k in range(27) if c[k] == (1 if up else -1))


# ---- K5: the schedule, in place, on one numpy buffer ----


def _k5_pulled(f_old, f_new, lay, order_rng, column_save=True):
    """What K5's schedule pulls: (27, X, Y, Z), slot k of each cell as the
    kernel reads it (sources clamped into the level; the face slots are
    overwritten later by the boundary masks).  `f` is updated in place with
    `f_new` plane by plane, as the kernel's stores do, so a value read after
    its cell was written would come out wrong."""
    f = f_old.copy()
    _, X, Y, Z = f.shape
    ty, chunk, xr, nr, nty = (lay[k] for k in ("ty", "chunk", "xr", "nr", "nty"))
    # launch 1: the edge copy
    ex = np.empty((max(2 * (nr - 1), 0), 9, Y, Z), f.dtype)
    ey = np.empty((max(2 * (nty - 1), 0), 9, X, Z), f.dtype)
    for b in range(nr - 1):
        for j in range(9):
            ex[2 * b, j] = f[il.kx(j, True), (b + 1) * xr - 1]
            ex[2 * b + 1, j] = f[il.kx(j, False), (b + 1) * xr]
    for b in range(nty - 1):
        for j in range(9):
            ey[2 * b, j] = f[il.ky(j, True), :, (b + 1) * ty - 1]
            ey[2 * b + 1, j] = f[il.ky(j, False), :, (b + 1) * ty]
    assert ex.size == lay["nx"] and ey.size == lay["ny"]
    pulled = np.full_like(f, np.nan)
    regions = [(t, r) for t in range(nty) for r in range(nr)]
    order_rng.shuffle(regions)
    # launch 2: one block per region, in no order
    for t, r in regions:
        y0, x0, x1 = t * ty, r * xr, min((r + 1) * xr, X)
        # shared memory starts with whatever it held (a finite marker here)
        save = np.full((2, 9, ty, chunk), 123.0, f.dtype)  # old cx = +1 slots
        col = np.full((2, 9, xr, ty), 123.0, f.dtype)      # old cz = +1 slots
        rows = np.arange(y0, min(y0 + ty, Y))
        for c in range(-(-Z // chunk)):
            z0 = c * chunk
            cols = np.arange(z0, min(z0 + chunk, Z))
            for xb in range(x0, x1):
                for k in range(27):
                    cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
                    xs = min(max(xb - cx, 0), X - 1)
                    ys = np.clip(rows - cy, 0, Y - 1)[:, None]
                    zs = np.clip(cols - cz, 0, Z - 1)[None, :]
                    in_tile = (ys >= y0) & (ys < y0 + ty)
                    ry = np.clip(ys - y0, 0, ty - 1)
                    val = f[k, xs, ys, zs]  # f itself: not written yet
                    if cx == 1 and xs >= x0:  # plane xb - 1 of this chunk
                        lane = np.clip(zs - z0, 0, chunk - 1)
                        here = in_tile & (zs >= z0) & (zs < z0 + chunk)
                        val = np.where(here, save[xs & 1, k // 3, ry, lane], val)
                    if column_save and cz == 1 and c > 0 and x0 <= xs < x1:  # chunk c - 1
                        before = in_tile & (zs < z0)
                        val = np.where(before, col[(c - 1) & 1, k - 18, xs - x0, ry],
                                       val)
                    jy = k % 3 + 3 * (k // 9)
                    if cy == 1 and t > 0:  # last row of y-tile t - 1
                        val = np.where(ys < y0, ey[2 * (t - 1), jy, xs, zs], val)
                    if cy == -1 and t + 1 < nty:  # first row of y-tile t + 1
                        val = np.where(ys >= y0 + ty, ey[2 * t + 1, jy, xs, zs], val)
                    if cx == 1 and xs < x0:  # last plane of run r - 1
                        val = ex[2 * (r - 1), k // 3, ys, zs]
                    if cx == -1 and xs >= x1:  # first plane of run r + 1
                        val = ex[2 * r + 1, k // 3, ys, zs]
                    pulled[k, xb, rows[:, None], cols[None, :]] = val
                # the old values later pulls need, then the "barrier"
                for j in range(9):
                    save[xb & 1, j, :len(rows), :len(cols)] = \
                        f[il.kx(j, True), xb, rows[:, None], cols[None, :]]
                    if z0 + chunk < Z:
                        col[c & 1, j, xb - x0, :len(rows)] = \
                            f[18 + j, xb, rows, z0 + chunk - 1]
                f[:, xb, rows[:, None], cols[None, :]] = \
                    f_new[:, xb, rows[:, None], cols[None, :]]
    assert np.array_equal(f, f_new)
    return pulled


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("interior,ty,chunk,xr", [
    ((11, 13, 19), 4, 8, 3),   # ragged tiles, chunks and runs
    ((8, 8, 16), 4, 8, 4),     # whole multiples
    ((9, 5, 7), 8, 16, 16),    # one region, one chunk
    ((10, 9, 33), 2, 4, 2),    # many chunks, a one-cell last chunk
], ids=["ragged", "multiples", "one-region", "thin"])
def test_k5_schedule_in_place_equals_plain_step(rng, interior, ty, chunk, xr,
                                                store_bf16):
    """Edge copy, regions in a shuffled order, every plane read before it is
    written: what K5 pulls, collided, is dense_stream_collide exactly."""
    patch, static = _level(interior, DOMAIN, rng)
    f, vel, _ = _inputs(patch, rng, store_bf16)
    want = ds.dense_stream_collide(f, vel, 0.04, 9, static, patch, **KW)
    f_new = want[0]
    if store_bf16:
        f_new = storage.decode_f(storage.encode_f(f_new, storage.STORE_BF16))
    X, Y, Z = interior
    lay = il.inplace_layout(X, Y, Z, 132, 2 if store_bf16 else 4, ty=ty,
                            chunk=chunk, xr=xr)
    pulled = torch.as_tensor(_k5_pulled(f.numpy(), f_new.numpy(), lay,
                                        np.random.default_rng(5)))
    assert not torch.isnan(pulled).any()

    def shift(a, cx, cy, cz):  # f[k] is 3-D, vel 4-D
        if a.dim() == 3:
            return pulled[(cx + 1) + 3 * (cy + 1) + 9 * (cz + 1)]
        return _shift_clamped(a, cx, cy, cz)

    got = ds._stream_collide(shift, f, vel, 0.04, 9, static, patch, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k5_schedule_emulation_sees_a_late_read(rng):
    """The emulation is sharp: with the column save left out (chunk c - 1's last column
    read from f after it was written) the pulls go wrong."""
    patch, static = _level((6, 5, 20), DOMAIN, rng)
    f, vel, _ = _inputs(patch, rng, False)
    f_new = ds.dense_stream_collide(f, vel, 0.04, 9, static, patch, **KW)[0]
    f, f_new = f.numpy(), f_new.numpy()
    lay = il.inplace_layout(6, 5, 20, 132, 4, ty=4, chunk=8, xr=3)
    good = _k5_pulled(f, f_new, lay, np.random.default_rng(5))
    k = 18 + 4  # cz = +1, cx = cy = 0: the old value of the cell below in z
    assert np.array_equal(good[k][:, :, 1:], f[k][:, :, :-1])
    bad = _k5_pulled(f, f_new, lay, np.random.default_rng(5), column_save=False)
    assert not np.array_equal(good, bad)
    assert np.array_equal(bad[k][:, :, 8], f_new[k][:, :, 7])


# ---- K3: the ring protocol ----

# K3's protocol.  A block marches over output planes x0 .. x1 - 1 of a level
# of X planes.  Its producer warps run step A on planes pa0 .. pa1 =
# max(x0 - 1, 0) .. min(x1, X - 1) into a ring of RING planes in shared
# memory, slot `plane % RING`; its consumer warps run step B of plane xb
# from ring planes xb - 1, xb, xb + 1.  Each slot has two named barriers,
# "full" (producers arrive, consumers wait) and "free" (consumers arrive,
# producers wait).

RING = 4  # A-planes held: xb - 1 .. xb + 2


def planes_made(x0: int, x1: int, X: int):
    """(pa0, pa1): the first and the last plane step A makes for a block."""
    return max(x0 - 1, 0), min(x1, X - 1)


def producer_events(x0: int, x1: int, X: int):
    """What a producer warp does, in order: ("wait", barrier), ("write",
    plane, slot), ("arrive", barrier).  It waits for "free" of its slot from
    the plane on that replaces another one."""
    pa0, pa1 = planes_made(x0, x1, X)
    for pl in range(pa0, pa1 + 1):
        slot = pl % RING
        if pl - pa0 >= RING:
            yield ("wait", ("free", slot))
        yield ("write", pl, slot)
        yield ("arrive", ("full", slot))


def consumer_events(x0: int, x1: int, X: int):
    """What a consumer warp does, in order: ("wait", barrier), ("read", xb,
    planes), ("arrive", barrier).  It waits once for "full" of each plane up
    to xb + 1 and frees plane xb - 1 after step B of plane xb, if the
    producers still make the plane that takes its slot."""
    pa0, pa1 = planes_made(x0, x1, X)
    ready = pa0 - 1
    for xb in range(x0, x1):
        need = min(xb + 1, X - 1)
        while ready < need:
            ready += 1
            yield ("wait", ("full", ready % RING))
        yield ("read", xb, [pl for pl in (xb - 1, xb, xb + 1) if 0 <= pl < X])
        if xb - 1 >= pa0 and xb - 1 + RING <= pa1:
            yield ("arrive", ("free", (xb - 1) % RING))



@pytest.mark.parametrize("x0,x1,X", [(0, 12, 12), (0, 4, 60), (8, 12, 60),
                                     (56, 60, 60), (5, 6, 7), (0, 1, 1),
                                     (3, 20, 21)])
def test_fused_pair_ring_protocol(x0, x1, X):
    """Producers and consumers of one block, stepped in random
    interleavings through the events above (which the kernel performs): a barrier lets a waiter pass only once the other side
    has arrived; no consumer reads a plane that is not in its ring slot; no
    producer overwrites a plane a consumer still needs; every barrier ends
    with arrivals and waits matched."""
    for seed in range(20):
        rng = np.random.default_rng(seed)
        agents = {"A": list(producer_events(x0, x1, X)),
                  "B": list(consumer_events(x0, x1, X))}
        pos = {"A": 0, "B": 0}
        arrived = {}  # barrier -> arrivals not yet consumed by a wait
        ring = [None] * RING
        read = []
        while any(pos[a] < len(agents[a]) for a in agents):
            ready = []
            for a in agents:
                if pos[a] == len(agents[a]):
                    continue
                ev = agents[a][pos[a]]
                if ev[0] == "wait" and arrived.get(ev[1], 0) == 0:
                    continue
                ready.append(a)
            assert ready, "deadlock"
            a = ready[rng.integers(len(ready))]
            ev = agents[a][pos[a]]
            pos[a] += 1
            if ev[0] == "arrive":
                arrived[ev[1]] = arrived.get(ev[1], 0) + 1
                assert arrived[ev[1]] == 1, ("barrier signalled twice", ev)
            elif ev[0] == "wait":
                arrived[ev[1]] -= 1
            elif ev[0] == "write":
                _, plane, slot = ev
                old = ring[slot]
                # the plane it replaces is read for the last time by step B
                # of the plane after it
                assert old is None or ("done", old + 1) in read, (ev, old)
                ring[slot] = plane
            elif ev[0] == "read":
                _, xb, planes = ev
                for pl in planes:
                    assert ring[pl % RING] == pl, (ev, ring)
                read.append(("done", xb))
        assert all(v == 0 for v in arrived.values()), arrived
        assert [xb for _, xb in read] == list(range(x0, x1))


# ---- K1: the launch geometry and the pull ----

import os
import re

from open_ludwig_torch.ops import build
from open_ludwig_torch.ops.collide_math import collide


def _k1_threads_per_block():
    with open(os.path.join(build.CSRC, "stream_collide.cu")) as fh:
        src = fh.read()
    return int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))


def _divisor(d):
    """(m, s) of K1's make_divisor: m = ceil(2^(31 + L) / d), L = ceil(log2
    d), s = L - 1; m = 0 for d = 1."""
    if d <= 1:
        return 0, 0
    L = int(d - 1).bit_length()
    return ((1 << (31 + L)) + d - 1) // d, L - 1


def _divide(n, d):
    """K1's divide(): umulhi(n, m) >> s, for uint64 arrays of n < 2^31."""
    m, s = _divisor(d)
    if m == 0:
        return n
    return ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 48, 56, 64, 104, 128, 216, 384, 5 * 7,
                               216 * 216, 384 * 384, 2 ** 30 + 7, 2 ** 31 - 1])
def test_k1_reciprocal_division_is_exact(d):
    m, _ = _divisor(d)
    assert m < 2 ** 32
    rng = np.random.default_rng(d)
    n = np.concatenate([rng.integers(0, 2 ** 31, 20000), np.arange(4096),
                        [2 ** 31 - 1, 2 ** 31 - 2], d * np.arange(1, 50) - 1,
                        d * np.arange(1, 50)]).astype(np.uint64) % np.uint64(2 ** 31)
    assert np.array_equal(_divide(n, d), n // np.uint64(d))


def _k1_cells(X, Y, Z):
    """Every thread of K1's grid (ceil(N / THREADS) blocks of THREADS), as
    the kernel indexes it: (x, y, z) of the threads that run, decoded from
    the flat cell by the reciprocals of Z and Y."""
    T = _k1_threads_per_block()
    N = X * Y * Z
    cell = (np.arange(-(-N // T))[:, None] * T + np.arange(T)[None, :]).ravel()
    cell = cell[cell < N].astype(np.uint64)
    r = _divide(cell, Z)
    z = cell - r * np.uint64(Z)
    x = _divide(r, Y)
    y = r - x * np.uint64(Y)
    return x.astype(np.int64), y.astype(np.int64), z.astype(np.int64)


@pytest.mark.parametrize("shape", [(64, 56, 56), (46, 48, 104), (60, 64, 128),
                                   (5, 7, 9), (3, 20, 1)],
                         ids=["L1", "L2", "L3", "odd-Z", "Z1"])
def test_k1_grid_covers_every_cell_once(shape):
    X, Y, Z = shape
    x, y, z = _k1_cells(X, Y, Z)
    assert (x < X).all() and (y < Y).all() and (z < Z).all()
    stored = np.zeros(shape, np.int64)
    np.add.at(stored, (x, y, z), 1)
    assert (stored == 1).all()
    assert _k1_threads_per_block() % 32 == 0


def _k1_sources(X, Y, Z):
    """The flat element of the (27, X, Y, Z) input that K1 loads for slot k
    of each cell (27, X, Y, Z): x and y clamped into the level, z unclamped
    (+1 / -1 off the source row's address); and each cell's six velocity
    neighbours (6, X, Y, Z: E, W, N, S, T, B) as its gradient reads them."""
    N, YZ = X * Y * Z, Y * Z
    x, y, z = _k1_cells(X, Y, Z)
    c = (x * Y + y) * Z + z
    dx = {-1: np.where(x + 1 < X, YZ, 0), 0: 0, 1: np.where(x > 0, -YZ, 0)}
    dy = {-1: np.where(y + 1 < Y, Z, 0), 0: 0, 1: np.where(y > 0, -Z, 0)}
    src = np.full((27, X, Y, Z), -1, np.int64)
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        src[k, x, y, z] = k * N + c + dx[cx] + dy[cy] - cz
    nb = np.full((6, X, Y, Z), -1, np.int64)
    nb[:, x, y, z] = np.stack([c + dx[-1], c + dx[1], c + dy[-1], c + dy[1],
                               c + np.where(z + 1 < Z, 1, 0), c - np.where(z > 0, 1, 0)])
    return src, nb


@pytest.mark.parametrize("interior", [(6, 7, 10), (5, 4, 9), (3, 4, 2)],
                         ids=["even-Z", "odd-Z", "Z2"])
def test_k1_pull_sources(interior):
    """K1's loads: inside f, the clamped pull's source wherever that is the
    true source (the slots whose source lies beyond a face differ only in
    z, and are the ones the face conditions overwrite), and the clamped
    velocity neighbours exactly."""
    X, Y, Z = interior
    N = X * Y * Z
    src, nb = _k1_sources(X, Y, Z)
    assert (src >= 0).all() and (src < 27 * N).all()
    ix, iy, iz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    for k in range(27):
        cx, cy, cz = int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k])
        sx, sy, sz = ix - cx, iy - cy, iz - cz
        inside = ((sx >= 0) & (sx < X) & (sy >= 0) & (sy < Y) & (sz >= 0) & (sz < Z))
        clamped = (k * N + (np.clip(sx, 0, X - 1) * Y + np.clip(sy, 0, Y - 1)) * Z
                   + np.clip(sz, 0, Z - 1))
        assert np.array_equal(src[k][inside], clamped[inside])
        assert np.array_equal(src[k] - clamped, sz - np.clip(sz, 0, Z - 1))
    for i, (ax, d) in enumerate(((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1))):
        n = [ix, iy, iz]
        n[ax] = np.clip(n[ax] + d, 0, interior[ax] - 1)
        assert np.array_equal(nb[i], (n[0] * Y + n[1]) * Z + n[2]), i


@pytest.mark.parametrize("faces", list(FACES))
@pytest.mark.parametrize("interior", [(6, 7, 10), (5, 4, 9)], ids=["even-Z", "odd-Z"])
def test_k1_pull_equals_plain_step(rng, interior, faces):
    """What K1's loads pull (`_k1_sources`), through the plain step's face
    masks and collision, equals the plain step exactly, on every face type."""
    patch, static = _level(interior, FACES[faces], rng)
    f, vel, iface = _inputs(patch, rng, False)
    want = ds.dense_stream_collide(f, vel, 0.04, 9, static, patch, iface=iface, **KW)
    src, _ = _k1_sources(*interior)
    pulled = f.reshape(-1)[torch.as_tensor(src)]

    def shift(a, cx, cy, cz):  # f[k] is 3-D, vel 4-D
        if a.dim() == 3:
            return pulled[(cx + 1) + 3 * (cy + 1) + 9 * (cz + 1)]
        return _shift_clamped(a, cx, cy, cz)

    got = ds._stream_collide(shift, f, vel, 0.04, 9, static, patch, iface=iface, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _crosses(face, k):
    """Slot k's source lies beyond face `face` (0/1 x low/high, 2/3 y, 4/5
    z) for a cell on that face."""
    c = (int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k]))[face // 2]
    return c < 0 if face % 2 else c > 0


def _on(face, cell, dims):
    return cell[face // 2] == (dims[face // 2] - 1 if face % 2 else 0)


@pytest.mark.parametrize("interior", [(6, 7, 9), (3, 4, 5), (1, 1, 1), (2, 1, 3)])
def test_faces_in_order_equal_the_precedence_chain(interior):
    """The kernels' face phase (`apply_faces` in csrc/lbm_cell.cuh) sets
    the slots face by face, z high, z low, y high, y low, x high, x low,
    each overwriting: every slot of every cell ends with the face that the
    precedence chain picks (x over y over z, the first face the slot
    crosses) and that the plain step's masks pick (applied z -> y -> x,
    later ones winning), and slots that cross no face keep the pull."""
    cells = np.stack(np.meshgrid(*[np.arange(n) for n in interior], indexing="ij"),
                     -1).reshape(-1, 3)
    for cell in cells:
        for k in range(27):
            chain = next((fc for fc in range(6)
                          if _crosses(fc, k) and _on(fc, cell, interior)), None)
            ordered = None
            for fc in (5, 4, 3, 2, 1, 0):
                if _on(fc, cell, interior) and _crosses(fc, k):
                    ordered = fc
            masked = None
            for axis in (2, 1, 0):  # the plain step's masks
                for fc in (2 * axis, 2 * axis + 1):
                    if _on(fc, cell, interior) and _crosses(fc, k):
                        masked = fc
            assert ordered == chain == masked, (tuple(cell), k)


def test_wall_model_off_its_range_is_no_wall_model(rng):
    """The identity the kernels' gate rests on (csrc/lbm_cell.cuh,
    collide_values): on cells whose wall distance is outside (0, 10) the
    plain collision with the wall model equals the one without, bit for
    bit, float32."""
    n = 4000
    f = torch.as_tensor((lat.W[:, None] * (1 + 0.1 * rng.standard_normal((27, n))))
                        .astype(np.float32))
    nbrs = tuple(torch.as_tensor((0.05 * rng.standard_normal((3, n))).astype(np.float32))
                 for _ in range(6))
    obstacle = torch.as_tensor(rng.random(n) < 0.05)
    sponge = torch.as_tensor(np.where(rng.random(n) < 0.3, rng.random(n), 0.0)
                             .astype(np.float32))
    wd = torch.as_tensor(rng.choice(np.array([100.0, 10.0, 0.0, -1.0, 1e4, 37.5],
                                             np.float32), n))
    kw = dict(tau=0.52, c_wale=0.5, nu_sgs_background=5e-4, sponge_blend=True)
    u_in = torch.tensor(0.04, dtype=torch.float32)
    on = collide(f, nbrs, obstacle, sponge, wd, u_in, wall_model=True, **kw)
    off = collide(f, nbrs, obstacle, sponge, wd, u_in, wall_model=False, **kw)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    # and inside the range the model acts
    near = collide(f, nbrs, obstacle, sponge, torch.full((n,), 0.7), u_in,
                   wall_model=True, **kw)
    assert not torch.equal(near[0], off[0])


# ---- K2: one launch over the links, a barrier between reads and writes ----


def _two_phase(flat, n, value, dst, order_rng, barrier):
    """The schedule of K2's and K6's launch (csrc/bouzidi_links.cuh) on one
    float32 numpy buffer: with the barrier, every link's value computed
    (phase 1, links in a shuffled order) before any is stored (phase 2,
    another order); without it, each link computed and stored in turn, as
    a launch with no barrier may run them."""
    order = order_rng.permutation(n)
    if barrier:
        vals = {i: value(i) for i in order}
        for i in order_rng.permutation(n):
            flat[dst(i)] = vals[i]
    else:
        for i in order:
            flat[dst(i)] = value(i)
    return flat


def _k2_model(f, plan, order_rng, barrier=True):
    """K2's links (signed S: a, 1 - a, the self bit) through `_two_phase`."""
    links = plan["links"]
    flat = f.reshape(-1).copy()
    N = f[0].size
    j = (links["code"] & 31).astype(np.int64)
    k = 26 - j
    oslot = np.where(links["code"] & ds.SELF_LINK, j, k)
    a = links["a"]
    b = np.float32(1.0) - a

    def value(i):
        return a[i] * flat[k[i] * N + links["cell"][i]] + b[i] * flat[oslot[i] * N + links["src"][i]]

    return _two_phase(flat, len(a), value, lambda i: j[i] * N + links["cell"][i],
                      order_rng, barrier).reshape(f.shape)


def _k6_model(f, plan, order_rng, barrier=True):
    """K6's links (two arrays: A, |B|, B's sign choosing the self slot or
    the far cell) through `_two_phase`."""
    links = {key: np.asarray(v.float() if key in ("A", "B") else v)
             for key, v in plan["links"].items()}
    flat = f.reshape(-1).copy()
    N = f[0].size
    j = links["j"].astype(np.int64)
    k = 26 - j
    cell, far, a, b = links["cell"], links["far"], links["A"], links["B"]

    def value(i):
        other = flat[j[i] * N + cell[i]] if b[i] < 0 else flat[k[i] * N + far[i]]
        return a[i] * flat[k[i] * N + cell[i]] + np.abs(b[i]) * other

    return _two_phase(flat, len(a), value, lambda i: j[i] * N + cell[i],
                      order_rng, barrier).reshape(f.shape)


def test_k2_schedule_equals_plain_and_needs_its_barrier():
    from test_torch_bouzidi_links import synthetic_plan

    plan = synthetic_plan()
    rng = np.random.default_rng(4)
    f = (lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + tuple(plan["level"])))).astype(np.float32)
    want = ds.apply_bouzidi_links(torch.as_tensor(f), plan).numpy()
    for seed in range(5):
        got = _k2_model(f, plan, np.random.default_rng(seed))
        assert np.array_equal(got, want)
    bad = [_k2_model(f, plan, np.random.default_rng(seed), barrier=False)
           for seed in range(5)]
    assert any(not np.array_equal(b, want) for b in bad)


def test_k6_schedule_equals_plain_and_needs_its_barrier():
    """K6's launch over its link list (shuffled, in two phases) equals its
    plain version, and fails without the barrier."""
    from test_torch_bouzidi_links import synthetic_plan

    plan = ds.bouzidi_ab_plan(synthetic_plan(), torch.float32)
    rng = np.random.default_rng(6)
    f = (lat.W[:, None, None, None] * (1 + 0.05 * rng.standard_normal(
        (27,) + tuple(plan["level"])))).astype(np.float32)
    want = ds.apply_bouzidi_ab_links(torch.as_tensor(f), plan).numpy()
    for seed in range(5):
        got = _k6_model(f, plan, np.random.default_rng(seed))
        assert np.array_equal(got, want)
    bad = [_k6_model(f, plan, np.random.default_rng(seed), barrier=False)
           for seed in range(5)]
    assert any(not np.array_equal(b, want) for b in bad)


# ---- tools ----


def test_build_variants_and_substitution(tmp_path):
    """A kernel built from another source directory or with extra flags
    gets its own library (and _LOADED key); `substituted` hands a library
    to the wrappers for the block only.  No nvcc is needed for this."""
    import shutil

    for f in ("stream_collide.cu", "lbm_cell.cuh"):
        shutil.copy(os.path.join(build.CSRC, f), tmp_path / f)
    libs = {build._paths("stream_collide", None, ())[1],
            build._paths("stream_collide", str(tmp_path), ())[1],
            build._paths("stream_collide", None, ("-DOL_K1_SECTIONS",))[1]}
    assert len(libs) == 3
    fake = build.Built(lib=None, path="x", seconds=0.0, ptxas_log="")
    key = build._key("stream_collide", None, ())
    before = build._LOADED.get(key)
    with build.substituted("stream_collide", fake):
        assert build.load("stream_collide") is fake
    assert build._LOADED.get(key) is before


def test_k4_shape_builds_are_distinct():
    """tools.probe_k4_shapes builds K4 once per fixed launch shape through
    the source's measurement hook: each shape gets its own library, and
    the hook and the shapes K4 chooses from are in the source."""
    from open_ludwig_torch.tools import probe_k4_shapes

    paths = {build._paths("stream_collide_flat", None, probe_k4_shapes._shape_flags(t, m))[1]
             for t, m in probe_k4_shapes.SHAPES}
    paths.add(build._paths("stream_collide_flat", None, ())[1])
    assert len(paths) == len(probe_k4_shapes.SHAPES) + 1
    with open(os.path.join(build.CSRC, "stream_collide_flat.cu")) as fh:
        src = fh.read()
    assert "#ifdef OL_K4_THREADS" in src
    for t, m in ((128, 8), (128, 10)):
        assert (t, m) in probe_k4_shapes.SHAPES and f"{t}, {m}>(p, s)" in src


def test_sass_counts_parses_a_listing():
    """`tools.sass_counts.count` on a cuobjdump-style listing: functions,
    predicated instructions, long addresses, modifiers dropped."""
    from open_ludwig_torch.tools import sass_counts

    listing = """
\tFunction : _Z3fooPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 IMAD.WIDE R2, R3, 0x4, R4 ;
        /*12340*/                   FFMA R0, R1, R2, R3 ;
\tFunction : _Z3barPf
        /*0000*/               @P1 BRA `(.L_x_1) ;
"""
    got = sass_counts.count(listing)
    assert [(f["function"], f["instructions"]) for f in got] == [
        ("_Z3fooPf", 3), ("_Z3barPf", 1)]
    assert got[0]["by_opcode"] == {"LDC": 1, "IMAD": 1, "FFMA": 1}
    assert got[1]["by_opcode"] == {"BRA": 1}

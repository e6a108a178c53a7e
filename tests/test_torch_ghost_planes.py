"""The ghost planes' CUDA kernels (`ops/ghost_planes.py`, csrc/ghost_planes.cu):
their tap tables and their dispatch, held here on the CPU, and the kernels
against their plain versions on a card.

- The tap tables (`dense_step.iface_taps`, in each group of the device
  plan) are the plan's UA3 / UB3 rows exactly, and a torch gather over
  them in the kernel's order (the temporal blend, each direction class
  pair's 2 x 2 stencil along B then A, rho and u at the direction's
  shifted position, the equilibrium split and the f_neq rescale) gives
  `interface_planes_pair_mm`'s planes within 2e-6: temporal on and off,
  g planes or f planes, float32 and bf16 parents, a parent with lo != 0,
  slabs clamped at the parent's edges, a group of one interface face
  (nf = 1) and a child with no interface face along an axis.
- The dispatch: on the CPU the scheduler runs the plain versions and
  counts each child build as "planes.plain" (`spans.COUNTS`), never
  calling the kernels' wrappers, and `cuda_step.LAUNCHES` keeps exactly
  the keys of the stream-collide and Bouzidi kernels (the benchmark's
  window check compares its changed keys with the launches a coarse step
  needs), while the kernels count their own launches apart
  (`ghost_planes.LAUNCHES`, captured and replayed as `cuda_step`'s); the
  graphed runner's carry copies a buffer of slabs in one copy.
- The plan: a card's plan carries no matrices of the plain contraction,
  which `iface_mm_matrices` adds for the plain version (the same planes);
  a build's bytes (`checks.ghost_build_bytes`) by part, the carry apart.
- On a card (`cuda` marker, skipped here): the kernels against the plain
  versions on the bench case's children (`checks.check_ghost_kernels`).
"""

import numpy as np
import pytest
import torch

from open_ludwig_torch import lattice as lat
from open_ludwig_torch import checks, spans
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.core.patch import BC_INTERFACE
from open_ludwig_torch.ops import cuda_step, ghost_planes
from open_ludwig_torch.ops import dense_step as ds
from open_ludwig_torch.ops import storage

torch.set_num_threads(2)

GEOMS = checks.GHOST_GEOMS
_levels = checks.ghost_levels


def _state(rng, shape, precision):
    f = (lat.W[:, None, None, None] * (1.0 + 0.05 * rng.standard_normal(
        (27,) + shape))).astype(np.float32)
    return {
        "f": storage.encode_f(torch.as_tensor(f), precision),
        "rho": torch.as_tensor((1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)),
        "vel": torch.as_tensor((0.03 * rng.standard_normal((3,) + shape)).astype(np.float32)),
    }


def planes_by_taps(plan, child, parent, slabs_old, slabs_new, use_temporal, g_shifted,
                   out_dtype):
    """The planes as the kernel computes them, by torch gathers over the
    plan's tap tables: per direction k, the class pair (c_a, c_b) of its
    transverse components picks a row of taps along A and along B; each
    field of the (blended) slabs is gathered at the 2 x 2 stencil, along B
    first, then along A."""
    scale = ds._fneq_scale(child, parent)
    blend = use_temporal and slabs_old is not None
    W = torch.as_tensor(lat.W)
    out = {}
    for gi, grp in enumerate(plan["groups"]):
        ax = grp["axis"]
        t0, t1 = [a for a in range(3) if a != ax]
        taps = grp["taps"]
        new = slabs_new[gi]

        def pair(key, _gi=gi, _new=new):
            n = _new[key]
            if not blend:
                return n.unsqueeze(1)
            o = slabs_old[_gi][key]
            return torch.stack([o, (o + n) * 0.5], dim=1)

        f, rho, vel = pair("f"), pair("rho"), pair("vel")

        def at(v, ca, cb, _taps=taps):
            col_a, w_a = _taps["col_a"][ca].long(), _taps["w_a"][ca]
            col_b, w_b = _taps["col_b"][cb].long(), _taps["w_b"][cb]
            vb = v[..., col_b[:, 0]] * w_b[:, 0] + v[..., col_b[:, 1]] * w_b[:, 1]
            return (vb[..., col_a[:, 0], :] * w_a[:, 0, None]
                    + vb[..., col_a[:, 1], :] * w_a[:, 1, None])

        nf, nw = f.shape[:2]
        plane = torch.empty((nf, nw, 27, grp["A"], grp["B"]))
        for k in range(27):
            c = (int(lat.C_X[k]), int(lat.C_Y[k]), int(lat.C_Z[k]))
            ca, cb = c[t0] + 1, c[t1] + 1
            ux, uy, uz = (at(vel[:, :, i], ca, cb) for i in range(3))
            r = at(rho, ca, cb)
            cu = c[0] * ux + c[1] * uy + c[2] * uz
            usq = ux * ux + uy * uy + uz * uz
            expr = r * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
            up = at(f[:, :, k], ca, cb)
            if g_shifted:
                feq = W[k] * (expr - 1.0)
                up = up if new["g"] else up - W[k]
            else:
                feq = W[k] * expr
                up = up + W[k] if new["g"] else up
            plane[:, :, k] = feq + (up - feq) * scale
        plane = plane.to(out_dtype)
        for i, face in enumerate(grp["faces"]):
            out[face] = plane[i]
    return out


@pytest.mark.parametrize("geom", list(GEOMS))
def test_tap_tables_are_the_plans_rows(geom):
    """Each tap row rebuilt as a matrix row is UA3's / UB3's row exactly,
    its columns ascending, and a merged row's second weight 0."""
    parent, child = _levels(geom)
    plan = ds.iface_mm_plan_to(ds.build_iface_mm_plan(child, parent), "cpu")
    n_groups = {"nf1": 3, "no_z": 2}.get(geom, 3)
    assert len(plan["groups"]) == n_groups
    for grp in plan["groups"]:
        for ax, key in (("a", "UA3"), ("b", "UB3")):
            col = grp["taps"]["col_" + ax].numpy()
            w = grp["taps"]["w_" + ax].numpy()
            assert col.dtype == np.int32 and w.dtype == np.float32
            M = np.zeros_like(grp[key])
            for c in range(3):
                for r in range(col.shape[1]):
                    for j in range(2):
                        M[c, r, col[c, r, j]] += w[c, r, j]
            assert np.array_equal(M, grp[key]), (key, grp["axis"])
            assert (col[..., 0] <= col[..., 1]).all()
            assert (w[..., 1][col[..., 0] == col[..., 1]] == 0).all()


@pytest.mark.parametrize("parent_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_shifted", [True, False], ids=["g", "f"])
@pytest.mark.parametrize("use_temporal", [True, False], ids=["temporal", "frozen"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_tap_gather_matches_pair_mm(geom, use_temporal, g_shifted, parent_dtype):
    """The gather over the tap tables against interface_planes_pair_mm from
    the same endpoint slabs: float32 planes within 2e-6, and in the storage
    type where the scheduler stores bf16 (g planes from bf16 states) at
    most one bf16 ulp apart."""
    rng = np.random.default_rng(11)
    parent, child = _levels(geom)
    plan = ds.iface_mm_plan_to(ds.build_iface_mm_plan(child, parent), "cpu")
    old, new = (_state(rng, parent.interior, parent_dtype) for _ in range(2))
    sl_old = ds.extract_endpoint_slabs(plan, old) if use_temporal else None
    sl_new = ds.extract_endpoint_slabs(plan, new)
    args = (plan, child, parent, sl_old, sl_new, use_temporal, g_shifted)
    want = ds.interface_planes_pair_mm(*args, torch.float32)
    got = planes_by_taps(*args, torch.float32)
    assert set(got) == set(want) == {f for f in range(6)
                                     if child.face_bc[f] == BC_INTERFACE}
    for face, pl in want.items():
        assert got[face].shape == pl.shape == (2 if use_temporal else 1, 27) + tuple(
            child.interior[t] for t in range(3) if t != face // 2)
        d = float((got[face] - pl).abs().max())
        assert d < 2e-6, (face, d)
    if parent_dtype == "bfloat16" and g_shifted:
        want16 = ds.interface_planes_pair_mm(*args, torch.bfloat16)
        got16 = planes_by_taps(*args, torch.bfloat16)
        for face, pl in want16.items():
            assert checks.bf16_ulps(got16[face], pl, got[face], want[face]) <= 1.0, face


def test_bf16_ulps():
    bf = torch.bfloat16
    a = torch.tensor([1.0, -0.5, 0.0], dtype=bf)
    assert checks.bf16_ulps(a, a) == 0.0
    # the bf16 ulp is 2^-7 at 1 and 2^-8 at 0.5
    assert checks.bf16_ulps(torch.tensor([1.0], dtype=bf),
                            torch.tensor([1.0078125], dtype=bf)) == 1.0
    assert checks.bf16_ulps(torch.tensor([-0.5], dtype=bf),
                            torch.tensor([-0.50390625], dtype=bf)) == 1.0
    assert checks.bf16_ulps(torch.tensor([1.0], dtype=bf),
                            torch.tensor([1.015625], dtype=bf)) == 2.0
    # beyond the float32 values' own distance: two roundings add one ulp
    a32, b32 = torch.tensor([1.0041]), torch.tensor([1.0035])
    assert checks.bf16_ulps(a32.to(bf), b32.to(bf), a32, b32) <= 1.0
    assert checks.bf16_ulps(torch.tensor([1.0], dtype=bf),
                            torch.tensor([1.015625], dtype=bf),
                            torch.tensor([1.0]), torch.tensor([1.0078125])) == 1.0


@pytest.fixture(scope="module")
def sphere2(tmp_path_factory):
    cfg, _, params, levels = checks.bench_case(
        str(tmp_path_factory.mktemp("ghost_sphere2")), surface_resolution=8,
        num_levels=2, steps=3, ramp_steps=2, wake_enabled=False, precision="float32")
    assert len(levels) == 2
    return cfg, params, levels


def test_cpu_runs_the_plain_planes_and_counts_them(sphere2, monkeypatch):
    """On the CPU every child build is the plain one, counted as
    "planes.plain", and the kernels' wrappers are never called."""
    cfg, params, levels = sphere2

    def boom(*a, **k):
        raise AssertionError("a ghost-plane kernel was called on the CPU")

    monkeypatch.setattr(ghost_planes, "extract_slabs", boom)
    monkeypatch.setattr(ghost_planes, "planes", boom)
    statics = sd.build_patch_statics(cfg, levels)
    states = [sd.init_patch_state(p, cfg.precision) for p in levels]
    before = spans.snapshot()
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    states = run(states, 1, 3)
    counts = spans.since(before)["counts"]
    # one child build a coarse step (level 1's one sub-step)
    assert counts.get("planes.plain") == 3 and "planes.kernel" not in counts
    assert all(torch.isfinite(s["rho"]).all() for s in states)
    lines = sd.kernel_log_lines(levels, statics, cfg.precision, "cpu")
    assert "plain torch (CPU)" in lines[1].split("ghost planes:")[1]


def test_launch_counters_keep_their_keys():
    """The ghost planes' kernels add no key to the launch counters: the
    benchmark's window check compares the keys a window changed with the
    launches of its coarse steps' stream-collide and Bouzidi kernels."""
    assert set(cuda_step.LAUNCHES) == {
        "stream_collide", "bouzidi", "fused_pair", "stream_collide_flat",
        "stream_collide_inplace", "bouzidi_ab", "stream_collide_shard",
        "bouzidi_shard", "stream_collide_flat_shard", "stream_collide_inplace_shard"}
    assert set(cuda_step.CAPTURED) == set(cuda_step.REPLAYED) == set(cuda_step.LAUNCHES)


def test_ghost_launch_counters(monkeypatch):
    """The ghost kernels' launch counters: their own keys, none shared with
    `cuda_step.LAUNCHES`; a launch under capture counts in CAPTURED too, so
    that the executed launches are the eager ones plus the replays'."""
    assert set(ghost_planes.LAUNCHES) == {"ghost_extract", "ghost_planes"}
    assert set(ghost_planes.CAPTURED) == set(ghost_planes.REPLAYED) == set(
        ghost_planes.LAUNCHES)
    assert not set(ghost_planes.LAUNCHES) & set(cuda_step.LAUNCHES)
    ghost_planes.reset_launches()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    ghost_planes._count("ghost_extract")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    ghost_planes._count("ghost_extract")
    ghost_planes._count("ghost_planes")
    assert ghost_planes.CAPTURED == {"ghost_extract": 1, "ghost_planes": 1}
    assert ghost_planes.executed_launches() == {"ghost_extract": 1, "ghost_planes": 0}
    ghost_planes.REPLAYED.update({"ghost_extract": 3, "ghost_planes": 3})
    assert ghost_planes.executed_launches() == {"ghost_extract": 4, "ghost_planes": 3}
    ghost_planes.reset_launches()
    assert ghost_planes.executed_launches() == {"ghost_extract": 0, "ghost_planes": 0}
    assert ghost_planes.LAUNCHES == ghost_planes.CAPTURED == ghost_planes.REPLAYED


@pytest.mark.parametrize("geom", list(GEOMS))
def test_plain_planes_add_their_matrices(geom):
    """A plan without the plain contraction's matrices (a card's) gives the
    same planes: `interface_planes_pair_mm` adds them (`iface_mm_matrices`),
    equal to the CPU plan's."""
    rng = np.random.default_rng(5)
    parent, child = _levels(geom)
    plan = ds.iface_mm_plan_to(ds.build_iface_mm_plan(child, parent), "cpu")
    keys = ("UA", "UBt", "UA_class", "UBt_class")
    bare = {**plan, "groups": [{k: v for k, v in g.items() if k not in keys}
                               for g in plan["groups"]]}
    full = ds.iface_mm_matrices(bare)
    assert ds.iface_mm_matrices(plan) is plan
    for g, h in zip(plan["groups"], full["groups"]):
        assert all(torch.equal(g[k], h[k]) for k in keys)
    old, new = (_state(rng, parent.interior, "float32") for _ in range(2))
    args = (child, parent, ds.extract_endpoint_slabs(plan, old),
            ds.extract_endpoint_slabs(plan, new), True)
    want = ds.interface_planes_pair_mm(plan, *args)
    got = ds.interface_planes_pair_mm(bare, *args)
    assert all(torch.equal(got[f], want[f]) for f in want)


@pytest.mark.parametrize("nw", [2, 1], ids=["temporal", "frozen"])
@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_ghost_build_bytes_by_part(store_bf16, nw):
    """A build's bytes by part: the extraction reads two parent planes a
    face (f in the storage type, rho and vel float32) and writes the
    float32 slabs; the planes read nw sets of slabs and write nw planes a
    face in the storage type; the carry, with the blend only, reads and
    writes one set of slabs."""
    parent, child = _levels("lo0")
    plan = ds.build_iface_mm_plan(child, parent)
    fb = 2 if store_bf16 else 4
    slab = window = plane = 0
    for g in plan["groups"]:
        t0, t1 = [a for a in range(3) if a != g["axis"]]
        cells = len(g["faces"]) * g["sizes"][t0] * g["sizes"][t1]
        slab += 31 * 4 * cells
        window += 2 * (27 * fb + 4 + 12) * cells
        plane += len(g["faces"]) * 27 * g["A"] * g["B"] * fb
    got = checks.ghost_build_bytes(plan, store_bf16, nw)
    assert got == {"extract": window + slab, "planes": nw * (slab + plane),
                   "carry": 2 * slab if nw == 2 else 0}


def test_carry_copies_one_buffer_of_slabs(monkeypatch):
    """Slabs that are views of one buffer (the extraction kernel's "buf") are
    carried in one copy; slabs without one, field by field."""
    def slabs(fill):
        buf = torch.full((2 * 31 * 6 + 31 * 4,), float(fill))
        out, o = [], 0
        for nf, wa, wb in ((2, 2, 3), (1, 2, 2)):
            n = nf * wa * wb
            out.append({"f": buf[o:o + 27 * n].view(nf, 27, wa, wb),
                        "rho": buf[o + 27 * n:o + 28 * n].view(nf, wa, wb),
                        "vel": buf[o + 28 * n:o + 31 * n].view(nf, 3, wa, wb),
                        "g": False, "buf": buf})
            o += 31 * n
        return out

    copies = []
    real = torch.Tensor.copy_

    def copy_(self, src, *a, **k):
        copies.append(self.shape)
        return real(self, src, *a, **k)

    old, new = slabs(1), slabs(2)
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    assert sd.FixedBuffers.carry(old, new) is old
    assert copies == [old[0]["buf"].shape]
    plain_old = [{k: s[k].clone() for k in ("f", "rho", "vel")} for s in slabs(3)]
    copies.clear()
    sd.FixedBuffers.carry(plain_old, new)
    monkeypatch.setattr(torch.Tensor, "copy_", real)
    assert len(copies) == 6
    for o, n, p in zip(old, new, plain_old):
        for key in ("f", "rho", "vel"):
            assert torch.equal(o[key], n[key]) and torch.equal(p[key], n[key])


def test_kernels_refuse_cpu_tensors():
    parent, child = _levels("lo0")
    plan = ds.iface_mm_plan_to(ds.build_iface_mm_plan(child, parent), "cpu")
    st = _state(np.random.default_rng(1), parent.interior, "float32")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ghost_planes.extract_slabs(plan, st)
    sl = ds.extract_endpoint_slabs(plan, st)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ghost_planes.planes(plan, child, parent, sl, sl, True)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are built with nvcc for "
                    "sm_90a and have no interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("use_temporal", [True, False], ids=["temporal", "frozen"])
@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_kernels_match_plain_on_the_bench(cuda_device, tmp_path, store_bf16,
                                          use_temporal):
    cfg, _, _, levels = checks.bench_case(
        str(tmp_path), precision="bfloat16" if store_bf16 else "float32")
    statics = sd.build_patch_statics(cfg, levels, cuda_device)
    for li in (1, 2):
        r = checks.check_ghost_kernels(levels[li], levels[li - 1],
                                       statics[li]["iface_mm"], store_bf16,
                                       use_temporal, 60 + li, cuda_device, reps=2)
        assert r["slabs_equal"], li
        assert r["max_abs_err"] < r["tol"], (li, r["max_abs_err"])
        if store_bf16:
            assert r["bf16_is_cast"] and r["max_ulps"] <= 1.0, (li, r["max_ulps"])
        assert (r["carry"] is None) == (not use_temporal)
        assert r["bytes"] == r["extract"]["bytes"] + r["planes"]["bytes"]


@pytest.mark.cuda
def test_graphed_batch_counts_the_kernels_it_ran(cuda_device, tmp_path):
    """The kernels' executed launches over a graphed batch of the bench case:
    the seeding's extractions, then an extraction and a planes launch a
    child build, the graphs' replays included."""
    cfg, _, params, levels = checks.bench_case(str(tmp_path), precision="float32")
    statics = sd.build_patch_statics(cfg, levels, cuda_device)
    w = torch.as_tensor(lat.W, device=cuda_device).view(27, 1, 1, 1)
    states = [{"f": w.expand((27,) + tuple(p.interior)).contiguous(),
               "rho": torch.ones(tuple(p.interior), device=cuda_device),
               "vel": torch.zeros((3,) + tuple(p.interior), device=cuda_device)}
              for p in levels]
    run = sd.make_batch_runner_dense(cfg, params, levels, statics)
    ghost_planes.reset_launches()
    for t0 in (1, 5, 9):
        states = run(states, t0, 4)
    torch.cuda.synchronize(cuda_device)
    assert run.graph_set.replays > 0
    builds = 12 * (2 ** (len(levels) - 1) - 1)
    assert ghost_planes.executed_launches() == {
        "ghost_extract": builds + len(levels) - 1, "ghost_planes": builds}


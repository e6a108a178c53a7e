"""The CUDA kernels K1 (stream-collide), K2 (Bouzidi), K3 (fused pair), K4
(flat stream-collide), K5 (in-place stream-collide) and K6 (two-array
Bouzidi) against their plain PyTorch versions on the card, at the shapes of
chip_smoke.py: the bench case's levels (sphere Re~1M, N=25, 3 levels) with
every face type, the 10.8M-cell single-level sweep shape, K1 at the level
shapes of the benchmark's cells with every face mix and the wall model on
and off, and the bench Bouzidi box; K3 + K2 on the bench's finest level and on the single-level
shape, also against K1 -> K2 -> K1 -> K2; K4 and K5 on the bench's level 1
and the single-level shape, also against K1 (equal), K4 also into
preallocated outputs; K6 over its links, also against K2 on the same S,
allocating nothing; the sharded forms of K1, K4, K5 (one x slab with its
neighbours' edge planes) and K2 (the box split between two slabs) against
their plain versions and against the unsharded kernels (equal); K2 on the
shipped wing's 10-cell-thick box and K3 + K2 on the shipped half model's
box, which lies on its finest level's y = 0 face; 600 coarse steps of a
developing 3-level sphere flow through `solve_case` on the card against
the CPU's plain path; the graphed batch runner (CUDA graph replays, the
step record on the card) bit-equal to the eager loop across a ramp on the
bench, the bench on 2 virtual slabs, the 10.8M-cell pair runner, the
shipped cube and the blocks layout, and `solve_case`'s forces.csv rows
the same in both modes.

Every test here needs an NVIDIA GPU and nvcc, and skips without them.  On
the card:  python -m pytest tests/test_torch_*.py -q
"""

import pytest
import torch

from open_ludwig_torch import checks
from open_ludwig_torch.solver_dense import build_patch_statics

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are built with nvcc for "
                    "sm_90a and have no interpret mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bench(cuda_device, tmp_path_factory):
    cfg, _, _, levels = checks.bench_case(str(tmp_path_factory.mktemp("bench")))
    statics = build_patch_statics(cfg, levels, cuda_device)
    kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
              inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
    return cfg, levels, statics, kw


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["L1", "L2-inlet-mix", "L2-outlet-mix", "L3"])
def test_stream_collide_kernel_matches_plain(bench, cuda_device, case, store_bf16):
    cfg, levels, statics, kw = bench
    cases = {label: (p, st) for label, p, st in checks.bench_k1_cases(levels, statics)}
    patch, static = cases[case]
    r = checks.check_stream_collide(patch, static, store_bf16, 17, kw, cuda_device,
                                    reps=1, plain_reps=1)
    assert r["finite"]
    assert r["max_abs_err"] < r["tol"], r["err"]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_stream_collide_kernel_sweep_shape(bench, cuda_device, tmp_path, store_bf16):
    cfg, _, _, kw = bench
    _, _, _, sweep = checks.bench_case(str(tmp_path), surface_resolution=25,
                                       num_levels=1, precision="float32")
    static = build_patch_statics(cfg, sweep, cuda_device)[0]
    r = checks.check_stream_collide(sweep[0], static, store_bf16, 18, kw,
                                    cuda_device, reps=1, plain_reps=1)
    assert r["finite"]
    assert r["max_abs_err"] < r["tol"], r["err"]


CELL_SHAPES = [s for s in checks.K1_SHAPES if s[0] != "64m_row"]


@pytest.mark.parametrize("wall_model", [True, False], ids=["wall", "nowall"])
@pytest.mark.parametrize("faces", list(checks.K1_FACES))
@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("label,shape,_", CELL_SHAPES, ids=[s[0] for s in CELL_SHAPES])
def test_stream_collide_kernel_at_the_cells_shapes(cuda_device, label, shape, _,
                                                   store_bf16, faces, wall_model):
    """K1 against its plain version at the K1 levels of the benchmark's
    cells (`checks.K1_SHAPES`; the 400^3 row's plain step would take tens
    of GB), with interface, mirror, inlet and outlet faces and the wall
    model on and off: the face phase runs each face's slots in turn."""
    patch, static = checks.k1_level(shape, faces, cuda_device)
    kw = dict(c_wale=0.3, nu_sgs_background=1e-4, inlet_turbulence=0.02,
              wall_model=wall_model, sponge_blend=True)
    r = checks.check_stream_collide(patch, static, store_bf16, 23, kw, cuda_device,
                                    reps=1, plain_reps=1)
    assert r["finite"]
    assert r["max_abs_err"] < r["tol"], r["err"]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_bouzidi_kernel_matches_plain(bench, cuda_device, store_bf16):
    _, levels, statics, _ = bench
    r = checks.check_bouzidi(levels[2], statics[2]["bouzidi"], store_bf16, 19,
                             cuda_device, reps=1, plain_reps=1)
    assert r["changed"] > 0
    assert r["max_abs_err"] < r["tol"], r
    assert r["peak_bytes"] == 0, r  # one launch over the links, no snapshot


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_bouzidi_ab_kernel_matches_plain(bench, cuda_device, store_bf16):
    """K6 (A and B in the storage dtype) against its plain version and
    against K2 on the same S, on the bench case's own Bouzidi box."""
    _, levels, statics, _ = bench
    r = checks.check_bouzidi_ab(levels[2], statics[2]["bouzidi"], store_bf16, 43,
                                cuda_device, reps=1, plain_reps=1)
    assert r["changed"] > 0
    assert r["max_abs_err"] < r["tol"], r
    assert r["k2_err"] < r["tol"], r
    assert r["peak_bytes"] == 0, r  # one launch over the links, no snapshot
    assert r["graph_ms"] > 0, r  # so a CUDA graph captures it


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_flat_kernel_into_preallocated_outputs(bench, sweep, cuda_device, store_bf16):
    """K4 with `out=` on the bench's level 1 and the 10.8M-cell level:
    the outputs given are written and returned, equal bit for bit to K4
    without `out=`, and within K1's tolerance of the plain version."""
    from open_ludwig_torch.ops import storage
    from open_ludwig_torch.ops.cuda_step import stream_collide_flat
    from open_ludwig_torch.ops.dense_step import stream_collide_flat_plain

    _, levels, statics, kw = bench
    for patch, static in ((levels[0], statics[0]), sweep):
        inp = checks.random_level_inputs(patch, store_bf16, 47, cuda_device)
        f, vel = inp["f"], inp["vel"]
        out = (torch.empty_like(f), torch.empty(f.shape[1:], device=cuda_device),
               torch.empty_like(vel))
        got = stream_collide_flat(f, vel, 0.04, 9, static, patch, out=out, **kw)
        want = stream_collide_flat(f, vel, 0.04, 9, static, patch, **kw)
        fp, rp, vp = stream_collide_flat_plain(storage.decode_f(f), vel, 0.04, 9,
                                               static, patch, **kw)
        if store_bf16:
            fp = storage.encode_f(fp, storage.STORE_BF16)
        torch.cuda.synchronize()
        assert all(g is o for g, o in zip(got, out))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        d = checks.state_diff(*got, fp, rp, vp)
        assert d["finite"] and d["max_abs_err"] < checks.K1_TOL[store_bf16], d


@pytest.fixture(scope="module")
def sweep(bench, cuda_device, tmp_path_factory):
    cfg = bench[0]
    _, _, _, levels = checks.bench_case(str(tmp_path_factory.mktemp("sweep")),
                                        surface_resolution=25, num_levels=1,
                                        precision="float32")
    return levels[0], build_patch_statics(cfg, levels, cuda_device)[0]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["L3", "sweep"])
def test_fused_pair_kernel_matches_plain(bench, sweep, cuda_device, case,
                                         store_bf16):
    """K3 + K2 against the plain pair + plain correction: on the bench's
    finest level (six interface faces, distinct ghost planes per sub-step,
    its own Bouzidi box) and on the 10.8M-cell single level (inlet, outlet
    and mirror faces, inlet noise, wall model, a sponge ramp, the sphere's
    Bouzidi box)."""
    _, levels, statics, kw = bench
    if case == "L3":
        patch, static = levels[2], checks.with_sponge_ramp(statics[2])
    else:
        patch, static = sweep[0], checks.with_sponge_ramp(sweep[1])
    r = checks.check_fused_pair(patch, static, static["bouzidi"], store_bf16,
                                23, kw, cuda_device, reps=1, plain_reps=1)
    assert r["finite"] and r["max_abs_err"] < r["tol"], r
    assert checks.within_k3_tol(r["unfused"], store_bf16), r["unfused"]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["L1", "sweep"])
@pytest.mark.parametrize("kernel", ["flat", "inplace"])
def test_flat_and_inplace_kernels_match_plain(bench, sweep, cuda_device, kernel,
                                              case, store_bf16):
    """K4 and K5 against their plain versions and against K1 on the bench's
    level 1 (inlet, outlet, mirrors) and on the 10.8M-cell single level,
    each with a sponge ramp; K5 from its own clone of the input."""
    _, levels, statics, kw = bench
    if case == "L1":
        patch, static = levels[0], checks.with_sponge_ramp(statics[0])
    else:
        patch, static = sweep[0], checks.with_sponge_ramp(sweep[1])
    check = checks.check_flat if kernel == "flat" else checks.check_inplace
    r = check(patch, static, store_bf16, 17, kw, cuda_device, reps=1, plain_reps=1)
    assert r["finite"] and r["max_abs_err"] < r["tol"], r
    assert r["k1"]["diff_frac"] == 0.0, r["k1"]
    if kernel == "inplace":
        assert r["same_ptr"] and r["vel_kept"]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,level,n,i", [("k1", 1, 3, 1), ("k1", 1, 2, 0),
                                            ("flat", 0, 3, 1), ("flat", 0, 2, 0),
                                            ("flat", 0, 2, 1), ("inplace", 0, 2, 1)])
def test_shard_step_kernels_match_plain(bench, cuda_device, kind, level, n, i,
                                        store_bf16):
    """The sharded forms of K1, K4 and K5 on one x slab of a bench level:
    within the plain version's tolerance, and the slab's stored f equal to
    the unsharded kernel's rows."""
    cfg, levels, statics, kw = bench
    r = checks.check_shard_step(kind, levels[level], checks.with_sponge_ramp(
        statics[level]), store_bf16, 61, kw, cuda_device, n, i, reps=1, plain_reps=1)
    assert r["finite"] and r["max_abs_err"] < r["tol"], r["err"]
    assert r["whole"]["diff_frac"] == 0.0, r["whole"]


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_bouzidi_shard_kernel_matches_plain(bench, cuda_device, store_bf16):
    """K2's sharded form on the bench box split through its middle: within
    the plain version's tolerance, and equal to the unsharded K2."""
    cfg, levels, statics, kw = bench
    plan = statics[2]["bouzidi"]
    cut = [0, plan["lo"][0] + plan["dim"][0] // 2, levels[2].interior[0]]
    r = checks.check_bouzidi_shard(levels[2], plan, store_bf16, 63, cut, cuda_device,
                                   reps=1, plain_reps=1)
    assert r["max_abs_err"] < r["tol"] and r["whole"]["diff_frac"] == 0.0, r


@pytest.fixture(scope="module")
def shipped(cuda_device, tmp_path_factory):
    """The shipped wing at 5 degrees and the half model of the Re~1M sphere
    (`checks.shipped_config`): config, levels and statics on the card."""
    out = {}
    for label, name, half in (("wing", "wing_5deg", False),
                              ("half", "sphere_re1m", True)):
        cfg = checks.shipped_config(str(tmp_path_factory.mktemp(label)), name,
                                    symmetric=half)
        levels = checks.case_levels(cfg)[2]
        out[label] = (cfg, levels, build_patch_statics(cfg, levels, cuda_device))
    return out


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_bouzidi_kernel_wing_thin_box(shipped, cuda_device, store_bf16):
    """K2 on the wing's finest box, 10 cells thick in z."""
    _, levels, statics = shipped["wing"]
    plan = statics[-1]["bouzidi"]
    assert plan["dim"][2] == 10, plan["dim"]
    r = checks.check_bouzidi(levels[-1], plan, store_bf16, 71, cuda_device,
                             reps=1, plain_reps=1)
    assert r["changed"] > 0 and r["max_abs_err"] < r["tol"], r
    assert r["peak_bytes"] == 0, r


@pytest.mark.parametrize("store_bf16", [False, True], ids=["f32", "bf16"])
def test_fused_pair_half_model_face_box(shipped, cuda_device, store_bf16):
    """K3 + K2 on the half model's finest level, whose Bouzidi box lies on
    the level's y = 0 face: against the plain pair and K1 -> K2 -> K1."""
    cfg, levels, statics = shipped["half"]
    plan = statics[-1]["bouzidi"]
    assert plan["lo"][1] == 0, plan["lo"]
    kw = dict(c_wale=cfg.c_wale, nu_sgs_background=cfg.nu_sgs_background,
              inlet_turbulence=0.02, wall_model=True, sponge_blend=True)
    r = checks.check_fused_pair(levels[-1], checks.with_sponge_ramp(statics[-1]), plan,
                                store_bf16, 73, kw, cuda_device, reps=1, plain_reps=1)
    assert r["finite"] and r["max_abs_err"] < r["tol"], r
    assert checks.within_k3_tol(r["unfused"], store_bf16), r["unfused"]


def test_long_run_matches_plain_path(cuda_device, tmp_path):
    """A developing flow over 600 coarse steps through `solve_case`: the
    sphere at Re~1M, N=10, 3 levels with the wake box, the wall model and
    Bouzidi, float32, on the card's kernels and on the CPU's plain path.
    Before the wake's chaos parts them, their forces.csv rows agree to
    the float32 drift of two summation orders (1e-3 in Cd and Cl; the
    JAX package's XLA path and the port's plain path keep this over the
    same steps): a kernel that misbehaves only in a developed flow would
    move them further."""
    import csv

    import yaml

    from open_ludwig_torch.cases import make_case_sphere
    from open_ludwig_torch.config import load_case_config
    from open_ludwig_torch.runner import solve_case

    d = str(tmp_path)
    make_case_sphere(d, "1M", surface_resolution=10, num_levels=3, steps=600,
                     ramp_steps=200, output_freq=10**9, diag_freq=50)
    with open(f"{d}/config.yaml") as fh:
        doc = yaml.safe_load(fh)
    doc["advanced"].setdefault("high_re", {})["min_coarse_blocks"] = 1
    with open(f"{d}/config.yaml", "w") as fh:
        yaml.safe_dump(doc, fh)
    rows = {}
    for device in ("cuda", "cpu"):
        cfg = load_case_config(d).with_overrides(output_dir=f"R_{device}")
        assert solve_case(cfg, device=device).steps == 600
        with open(f"{cfg.output_path}/forces.csv") as fh:
            rows[device] = list(csv.DictReader(fh))
    assert len(rows["cuda"]) == len(rows["cpu"]) == 12
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert a["Step"] == b["Step"]
        for key in ("Cd", "Cl"):
            assert abs(float(a[key]) - float(b[key])) <= 1e-3, (a["Step"], key, a, b)


def _graph_vs_eager(make, fresh, calls=((1, 7), (8, 12), (20, 3), (23, 18)),
                    gather=lambda s: s):
    """The eager loop and the graphed runner from equal states over calls
    across a 20-step ramp: the states bit for bit, and the kernel launches
    the graphed run executed (its captured launches times its replays)
    equal to the eager run's."""
    from open_ludwig_torch.ops import cuda_step

    out, launches = {}, {}
    for graphs in (False, True):
        run = make(graphs)
        st = fresh()
        cuda_step.reset_launches()
        for t0, n in calls:
            st = run(st, t0, n)
        torch.cuda.synchronize()
        out[graphs], launches[graphs] = gather(st), cuda_step.executed_launches()
        if graphs:
            assert run.graph_set.graphs and run.graph_set.replays > 0
    assert launches[True] == launches[False]

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for a, b in zip(out[False], out[True]):
        for k in ("f", "rho", "vel"):
            assert torch.equal(bits(a[k]), bits(b[k])), k


def _random_states(levels, precision, seed, device):
    from open_ludwig_torch import lattice as lat
    from open_ludwig_torch.ops import storage

    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=device).view(27, 1, 1, 1)
    out = []
    for p in levels:
        sh = tuple(p.interior)

        def randn(shape):
            return torch.randn(shape, generator=gen, device=device)
        out.append({"f": storage.encode_f(w * (1 + 0.03 * randn((27,) + sh)), precision),
                    "rho": 1 + 0.01 * randn(sh), "vel": 0.02 * randn((3,) + sh)})
    return out


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["bench", "bench_2slabs", "single", "single_k5"])
def test_graph_replay_equals_eager_loop(cuda_device, tmp_path, case, precision):
    """The graphed batch runner (each coarse step, or pair, one CUDA graph
    replay, the step record on the card) against the eager loop, bit for
    bit: the bench case, the bench on a virtual mesh of 2 slabs, the
    single-level pair runner (the 10.8M-cell case) and that level on K5 in
    place (each replay's edge copy reads what the previous one wrote)."""
    from open_ludwig_torch.parallel.patch_shard import XMesh, gather_states, shard_states
    from open_ludwig_torch.solver_dense import make_batch_runner_dense

    single = case.startswith("single")
    over = dict(surface_resolution=25, num_levels=1) if single else {}
    cfg, _, params, levels = checks.bench_case(str(tmp_path), precision=precision,
                                               ramp_steps=20, **over)
    cfg = cfg.with_overrides(inlet_turbulence_intensity=0.02)
    mesh = XMesh([cuda_device] * 2) if case == "bench_2slabs" else None
    statics = build_patch_statics(cfg, levels, cuda_device, x_mesh=mesh)
    if case == "single_k5":
        statics = [{**s, "engine": "inplace", "engine_why": "forced"} for s in statics]
    if mesh is None:
        fresh = lambda: _random_states(levels, precision, 5, cuda_device)  # noqa: E731
        gather = lambda s: s  # noqa: E731
    else:
        fresh = lambda: shard_states(_random_states(levels, precision, 5,  # noqa: E731
                                                    cuda_device), mesh)
        gather = lambda s: gather_states(s, cuda_device)  # noqa: E731
    _graph_vs_eager(lambda g: make_batch_runner_dense(cfg, params, levels, statics,
                                                      x_mesh=mesh, graphs=g),
                    fresh, gather=gather)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_graph_replay_equals_eager_loop_cube(cuda_device, tmp_path, precision):
    """The shipped cube: 4 levels, four K3 pairs a coarse step."""
    from open_ludwig_torch.solver_dense import make_batch_runner_dense

    cfg = checks.shipped_config(str(tmp_path), "cube").with_overrides(
        precision=precision, ramp_steps=20, inlet_turbulence_intensity=0.02)
    _, params, levels = checks.case_levels(cfg)
    assert len(levels) == 4
    statics = build_patch_statics(cfg, levels, cuda_device)
    _graph_vs_eager(lambda g: make_batch_runner_dense(cfg, params, levels, statics,
                                                      graphs=g),
                    lambda: _random_states(levels, precision, 7, cuda_device))


def test_graph_replay_equals_eager_loop_blocks(cuda_device, tmp_path):
    """`layout: blocks` (float32): the plain-torch block step captured."""
    from open_ludwig_torch import solver
    from open_ludwig_torch.core.state import build_all
    from open_ludwig_torch.domain.builder import setup_case

    cfg = checks.bench_config(str(tmp_path), precision="float32", ramp_steps=20
                              ).with_overrides(layout="blocks",
                                               inlet_turbulence_intensity=0.02)
    _, params, levels = setup_case(cfg)
    base, statics = build_all(cfg, params, levels, cuda_device)
    _graph_vs_eager(lambda g: solver.make_batch_runner(cfg, params, statics, graphs=g),
                    lambda: [{k: v.clone() for k, v in st.items()} for st in base],
                    calls=((1, 7), (8, 14), (22, 3)))


def test_solve_case_graphs_write_the_eager_rows(cuda_device, tmp_path):
    """`solve_case` graphed (its default on a card) and eager: identical
    forces.csv rows over a run that crosses the ramp."""
    from open_ludwig_torch.runner import solve_case

    cfg = checks.bench_config(str(tmp_path), steps=40, ramp_steps=20, diag_freq=10
                              ).with_overrides(inlet_turbulence_intensity=0.02)
    rows = {}
    for graphs in (True, False):
        c = cfg.with_overrides(output_dir=f"R_{graphs}")
        res = solve_case(c, device="cuda", graphs=graphs)
        assert ("[Graph] dense" in res.graph_report) == graphs
        with open(f"{c.output_path}/forces.csv") as fh:
            rows[graphs] = fh.read().splitlines()
    assert rows[True] == rows[False] and len(rows[True]) == 5

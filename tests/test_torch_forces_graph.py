"""The stress map's force sample as one CUDA graph replay and one read-back
(`open_ludwig_torch/ops/forces.py`: `pack`, `unpack`, `graph_key`,
`ForceGraphs`), on a made-up force context over a small grid:

- (a) `pack` then `unpack` gives back the float32 maps and the float64 sums
  bit for bit, -0.0, subnormals, 1e30 and NaN included;
- (b) the key and the cap are host logic: the same address, shape, stride
  and dtype give the same key and any difference a new one; the first two
  keys capture (the capture stood in for on the CPU), a repeated key
  replays, and a third key runs eagerly and counts `forces.eager`;
- (c) on the CPU `compute_aerodynamics` makes five blocking copies a call
  and counts nothing else, and its result is bit-equal to a copy, kept
  here, of the five-copy evaluation the port had before the graph path;
- (d) on a card (skipped without one): the replay bit-equal to the eager
  evaluation, also after the state changed in place, the second call
  capturing nothing, one blocking copy a call, and the step graphs'
  counters unmoved.
"""

import dataclasses

import numpy as np
import pytest
import torch

from open_ludwig_torch import spans
from open_ludwig_torch.ops import forces

GRID = (6, 5, 7)
FLAGS = [(sym, ext) for sym in (False, True) for ext in (False, True)]


def make_ctx(n_tri, symmetric, extrapolate, seed=3, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    n_cells = int(np.prod(GRID))

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    normals = torch.randn((3, n_tri), generator=gen)
    normals = normals / normals.norm(dim=0, keepdim=True)
    wall = 1.5 * rand(n_tri)
    wall[::7] = 0.005  # below the shear cut-off
    dn1 = 0.5 + rand(n_tri)
    ctx = forces.ForceContext(
        cell_idx=torch.randint(0, n_cells, (n_tri,), generator=gen),
        wall_dist=wall,
        found=rand(n_tri) > 0.1,
        normals=normals,
        areas=1e-3 * rand(n_tri),
        centers=torch.randn((3, n_tri), generator=gen),
        moment_center=torch.randn((3,), generator=gen),
        tau_molecular=0.5004,
        pressure_scale=1.225 * 40.0 ** 2,
        q_inf=0.5 * 1.225 * 20.0 ** 2,
        area_ref=0.07,
        chord_ref=0.3,
        symmetric=symmetric,
        cell_idx2=torch.randint(0, n_cells, (n_tri,), generator=gen),
        found2=rand(n_tri) > 0.3,
        dn1=dn1,
        dn2=dn1 + 2.0 * rand(n_tri) - 0.2,
        extrapolate=extrapolate,
    )
    if device == "cpu":
        return ctx
    moved = {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx) if f.init}
    return forces.ForceContext(**{k: v.to(device) if torch.is_tensor(v) else v
                                  for k, v in moved.items()})


def make_state(seed=5, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    state = {"rho": 1.0 + 0.01 * torch.randn(GRID, generator=gen),
             "vel": 0.05 * torch.randn((3,) + GRID, generator=gen)}
    state["vel"][:, 0, 0, :] = 0.0  # cells with no tangential velocity
    return {k: v.to(device) for k, v in state.items()}


def five_copies(state, ctx):
    """The port's force evaluation before the graph path: the map's
    launches, then its five results copied to the host one by one."""
    p, tau_vec, Fp, Fv, M = forces._surface_stresses(
        state["rho"].reshape(-1), state["vel"].reshape(3, -1), ctx)
    Fp, Fv, M = Fp.double(), Fv.double(), M.double()
    Fp, Fv, M, p, tau_vec = (t.cpu().numpy() for t in (Fp, Fv, M, p, tau_vec))
    if ctx.symmetric:
        Fp = np.array([2 * Fp[0], 0.0, 2 * Fp[2]])
        Fv = np.array([2 * Fv[0], 0.0, 2 * Fv[2]])
        M = np.array([0.0, 2 * M[1], 0.0])
    F = Fp + Fv
    res = forces.ForceResult(
        Fx=F[0], Fy=F[1], Fz=F[2],
        Fx_pressure=Fp[0], Fy_pressure=Fp[1], Fz_pressure=Fp[2],
        Fx_viscous=Fv[0], Fy_viscous=Fv[1], Fz_viscous=Fv[2],
        Mx=M[0], My=M[1], Mz=M[2], pressure_map=p, shear_map=tau_vec)
    F_ref = ctx.q_inf * ctx.area_ref
    M_ref = F_ref * ctx.chord_ref
    if F_ref > 1e-10:
        res.Cd, res.Cl, res.Cs = F[0] / F_ref, F[2] / F_ref, F[1] / F_ref
    if M_ref > 1e-10:
        res.Cmx, res.Cmy, res.Cmz = M[0] / M_ref, M[1] / M_ref, M[2] / M_ref
    return res


SCALARS = [f.name for f in dataclasses.fields(forces.ForceResult)
           if f.name not in ("pressure_map", "shear_map", "force_map")]


def assert_bit_equal(a, b):
    for name in SCALARS:
        x, y = np.float64(getattr(a, name)), np.float64(getattr(b, name))
        assert x.tobytes() == y.tobytes(), (name, x, y)
    for name in ("pressure_map", "shear_map"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


SPECIAL = [-0.0, 0.0, 1e-40, -1.4e-45, 1e30, -3.4e38, float("nan"), float("inf"), 1.0 / 3.0]


@pytest.mark.parametrize("n_tri", [1, 5, 257])
def test_pack_unpack_is_bit_exact(n_tri):
    gen = torch.Generator().manual_seed(n_tri)
    p = torch.randn((n_tri,), generator=gen)
    tau = torch.randn((3, n_tri), generator=gen)
    sums = [torch.randn((3,), generator=gen) for _ in range(3)]
    vals = torch.tensor(SPECIAL, dtype=torch.float32)
    flat = tau.view(-1)
    flat[:len(SPECIAL)] = vals[:flat.numel()]
    p[:len(SPECIAL)] = vals[:n_tri]
    sums[0][:] = vals[:3]
    sums[1][:] = vals[3:6]
    sums[2][:] = vals[6:9]
    buf = forces.pack(p, tau, *sums)
    assert buf.dtype == torch.float64 and buf.numel() == 9 + 4 * n_tri
    Fp, Fv, M, p2, tau2 = forces.unpack(buf.numpy(), n_tri)
    for got, want in ((Fp, sums[0]), (Fv, sums[1]), (M, sums[2])):
        assert got.dtype == np.float64
        assert got.tobytes() == want.double().numpy().tobytes()
    assert p2.tobytes() == p.numpy().tobytes()
    assert tau2.shape == (3, n_tri) and tau2.tobytes() == tau.numpy().tobytes()


def _views(t):
    """(view of t, same key?): the same tensor seen again, and a new
    address, shape, stride or dtype."""
    column_major = tuple(int(np.prod(t.shape[:i])) for i in range(t.dim()))
    return [(t, True), (t.view(t.shape), True), (t[...], True),
            (t.clone(), False),  # address
            (t.reshape(-1), False),  # shape
            (t.as_strided(t.shape, column_major), False),  # stride
            (t.view(torch.int32), False),  # dtype
            (t.transpose(-1, -2), False),
            (t[1:], False)]


@pytest.mark.parametrize("which", ["rho", "vel"])
@pytest.mark.parametrize("case", range(9))
def test_graph_key(which, case):
    state = make_state()
    other = "vel" if which == "rho" else "rho"
    view, same = _views(state[which])[case]
    args = {which: view, other: state[other]}
    key = forces.graph_key(args["rho"], args["vel"])
    assert (key == forces.graph_key(state["rho"], state["vel"])) is same
    assert hash(key) == hash(forces.graph_key(args["rho"], args["vel"]))


class StandIn:
    """A captured graph's stand-in on the CPU: a replay reruns the map into
    the output vector."""

    def __init__(self, rho, vel, ctx):
        self.args = (rho, vel, ctx)
        self.out = torch.full((9 + 4 * ctx.n_tri,), float("nan"), dtype=torch.float64)

    def replay(self):
        self.out.copy_(forces._packed(*self.args))


@pytest.mark.parametrize("sym,ext", FLAGS)
def test_the_cap_evaluates_the_third_key_eagerly(monkeypatch, sym, ext):
    def capture(self, rho, vel, ctx):
        g = StandIn(rho, vel, ctx)
        return g, g.out

    monkeypatch.setattr(forces.ForceGraphs, "_capture", capture)
    ctx = make_ctx(40, sym, ext)
    states = [make_state(seed) for seed in (11, 12, 13)]
    fg = ctx.graphs
    order = [(0, "forces.capture"), (0, "forces.graph"), (1, "forces.capture"),
             (2, "forces.eager"), (1, "forces.graph"), (2, "forces.eager"),
             (0, "forces.graph")]
    for i, counter in order:
        st = states[i]
        before = spans.snapshot()
        out = fg.packed(st["rho"], st["vel"], ctx)
        assert spans.since(before)["counts"] == {counter: 1}
        want = forces._packed(st["rho"], st["vel"], ctx)
        assert out.numpy().tobytes() == want.numpy().tobytes()
    assert len(fg.graphs) == forces.ForceGraphs.LIMIT == 2


@pytest.mark.parametrize("sym,ext", FLAGS)
def test_cpu_path_is_the_five_copy_evaluation(sym, ext):
    ctx = make_ctx(60, sym, ext)
    state = make_state()
    before = spans.snapshot()
    for _ in range(2):
        got = forces.compute_aerodynamics(state, ctx)
        assert_bit_equal(got, five_copies(state, ctx))
    since = spans.since(before)
    assert since["counts"] == {"sync.forces": 10}
    assert since["spans"]["forces"][0] == 2 and since["spans"]["forces.readback"][0] == 2
    assert not ctx.graphs.graphs
    assert "forces.capture" not in since["spans"] and "forces.replay" not in since["spans"]


def test_a_new_context_starts_without_graphs():
    ctx = make_ctx(10, False, True)
    ctx.graphs.graphs["k"] = None
    assert not dataclasses.replace(ctx, symmetric=True).graphs.graphs
    assert "graphs" not in repr(ctx)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph path runs on a card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sym,ext", FLAGS)
def test_card_replay_equals_the_eager_evaluation(card, sym, ext):
    dev = card
    ctx = make_ctx(300, sym, ext, device=dev)
    state = make_state(device=dev)
    eager = forces.force_result(forces.eager_sums(state["rho"], state["vel"], ctx), ctx)
    assert_bit_equal(eager, five_copies(state, ctx))
    steps = {k: spans.COUNTS.get(k) for k in ("graph.ops", "graph.steps")}
    for i, counter in enumerate(("forces.capture", "forces.graph", "forces.graph")):
        before = spans.snapshot()
        got = forces.compute_aerodynamics(state, ctx)
        assert spans.since(before)["counts"] == {"sync.forces": 1, counter: 1}, i
        assert_bit_equal(got, eager)
    # the replay reads the caller's tensors where they lie
    state["rho"].mul_(1.001)
    state["vel"].mul_(0.9)
    before = spans.snapshot()
    got = forces.compute_aerodynamics(state, ctx)
    assert spans.since(before)["counts"] == {"sync.forces": 1, "forces.graph": 1}
    assert_bit_equal(got, forces.force_result(
        forces.eager_sums(state["rho"], state["vel"], ctx), ctx))
    assert {k: spans.COUNTS.get(k) for k in steps} == steps
    assert len(ctx.graphs.graphs) == 1 and ctx.graphs.pool_bytes > 0

"""The warm start and its storage encoding, and the work count against hand
arithmetic."""

import pytest
import torch

from lbm_bench import work, warm
from lbm_bench.reference.olt import lattice as lat

SEED = 2 ** 31 + 77  # seeds may exceed 32 signed bits


def _obstacle():
    ob = torch.zeros((6, 5, 7), dtype=torch.bool)
    ob[2:4, 1:3, 2:5] = True
    return ob


@pytest.mark.parametrize("bf16", [False, True])
def test_warm_state_moments_and_storage(bf16):
    ob = _obstacle()
    st = warm.warm_states([ob], 0.03, bf16, SEED, 1e-3, 0.05)[0]
    f = st["f"].float() + (lat.w_view("cpu", 4) if bf16 else 0)
    assert st["f"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    # obstacle cells hold the rest state exactly: f = w (g = 0), rho 1, u 0
    assert torch.equal(st["rho"][ob], torch.ones(int(ob.sum())))
    assert torch.equal(st["vel"][:, ob], torch.zeros(3, int(ob.sum())))
    assert torch.equal(f[:, ob], lat.w_view("cpu", 2).expand(27, int(ob.sum())))
    # fluid cells: rho and u are the moments of f (bf16 g rounds to ~2^-9 |g|)
    tol = 2e-4 if bf16 else 2e-6
    C = torch.as_tensor(lat.C)
    rho = f.sum(0)
    mom = torch.einsum("dk,kxyz->dxyz", C, f) / rho
    assert torch.allclose(rho, st["rho"], atol=tol)
    assert torch.allclose(mom, st["vel"], atol=tol)
    fluid = ~ob
    assert (st["rho"][fluid] - 1).abs().max() <= 1e-3
    assert (st["vel"][0][fluid] - 0.03).abs().max() <= 0.05 * 0.03 + 1e-9
    assert st["vel"][0][fluid].std() > 0  # perturbed cell by cell


def test_warm_state_encoding_is_g_minus_w():
    ob = _obstacle()
    f32 = warm.warm_states([ob], 0.03, False, SEED, 1e-3, 0.05)[0]
    g = warm.warm_states([ob], 0.03, True, SEED, 1e-3, 0.05)[0]
    want = (f32["f"] - lat.w_view("cpu", 4)).to(torch.bfloat16)
    assert (g["f"].float() - want.float()).abs().max() <= 2 ** -8 * want.float().abs().max()
    assert torch.equal(g["rho"], f32["rho"]) and torch.equal(g["vel"], f32["vel"])


def test_warm_state_seeded_and_independent_of_obstacle():
    ob = _obstacle()
    a = warm.warm_states([ob, ob], 0.03, False, SEED, 1e-3, 0.05)
    b = warm.warm_states([ob, ob], 0.03, False, SEED, 1e-3, 0.05)
    c = warm.warm_states([ob, ob], 0.03, False, SEED + 1, 1e-3, 0.05)
    d = warm.warm_states([torch.zeros_like(ob), ob], 0.03, False, SEED, 1e-3, 0.05)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in ("f", "rho", "vel"))
    assert not torch.equal(a[0]["rho"], c[0]["rho"])
    # a level's draws do not depend on its (or an earlier level's) obstacle
    assert torch.equal(a[1]["vel"], d[1]["vel"])
    fluid = ~ob
    assert torch.equal(a[0]["rho"][fluid], d[0]["rho"][fluid])


@pytest.mark.parametrize("bf16", [False, True])
def test_warm_state_written_into_a_levels_tensors(bf16):
    ob = _obstacle()
    new = warm.warm_states([ob, ob], 0.03, bf16, SEED, 1e-3, 0.05)
    bufs = [{k: torch.full_like(st[k], 7.0) for k in ("f", "rho", "vel")} for st in new]
    got = warm.warm_states([ob, ob], 0.03, bf16, SEED, 1e-3, 0.05, out=bufs)
    for g, b, n in zip(got, bufs, new):
        for k in ("f", "rho", "vel"):
            assert g[k].data_ptr() == b[k].data_ptr() and torch.equal(g[k], n[k])
    with pytest.raises(ValueError):
        warm.warm_states([ob], 0.03, not bf16, SEED, 1e-3, 0.05, out=bufs[:1])


def test_step_work_by_hand():
    # a 10 x 20 x 30 level, bf16, wall model, interface faces on y- and z+
    faces = (0, 1, 4, 2, 3, 4)
    nbytes, ops = work.step_work((10, 20, 30), faces, True, True, 1)
    per_cell = 54 + 12 + 1 + 4 + 4 + 54 + 4 + 12  # f, vel, obstacle, sponge, wall, f, rho, vel
    assert per_cell == 145
    planes = 27 * (10 * 30) * 2 + 27 * (10 * 20) * 2  # the y face's and the z face's
    assert nbytes == 6000 * 145 + planes
    assert ops == 6000 * work.CELL_OPS
    # float32 without the wall model: 253 - 4 bytes a cell, no planes
    assert work.step_work((10, 20, 30), (0, 1, 2, 2, 3, 3), False, False)[0] == 6000 * 249
    # two fused sub-steps read f once but each sub-step's planes
    assert work.step_work((10, 20, 30), faces, True, True, 2)[0] == 6000 * 145 + 2 * planes


def test_least_seconds_and_launches():
    name = "NVIDIA H100 80GB HBM3"
    assert work.least_seconds(3.35e12, 0, name) == pytest.approx(1.0)
    assert work.least_seconds(0, 67e12, name) == pytest.approx(1.0)
    assert work.least_seconds(1, 1, "cpu") is None
    levels = [{"interior": (10, 20, 30), "face_bc": (0, 1, 2, 2, 3, 3), "sub_steps": 1},
              {"interior": (8, 8, 8), "face_bc": (4,) * 6, "sub_steps": 2}]
    b0 = work.step_work((10, 20, 30), (0, 1, 2, 2, 3, 3), False, True)[0]
    b1 = work.step_work((8, 8, 8), (4,) * 6, False, True)[0]
    assert work.steps_least_seconds(levels, False, True, 3, name) == pytest.approx(
        3 * (b0 + 2 * b1) / 3.35e12)
    assert work.batch_launches(["flat", "k1", "k1"], [False, False, True], 5) == {
        "stream_collide_flat": 5, "stream_collide": 10 + 20, "bouzidi": 20}


def test_warm_up_rule():
    count = {"n": 0, "calls": 0}

    def call():
        count["calls"] += 1
        if count["calls"] < 3:
            count["n"] += 5
    assert work.warm_up(call, lambda: count["n"]) == 3
    with pytest.raises(RuntimeError):
        work.warm_up(lambda: count.__setitem__("n", count["n"] + 1), lambda: count["n"])

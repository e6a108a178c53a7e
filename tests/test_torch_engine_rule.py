"""The card's kernel rule (`ops/engine.card_engines`) on the benchmark's
cells, the shipped cases and the sweep rows, on the CPU.

- Each cell's configuration in `lbm_bench/configs/` gives the engines the
  benchmark runs: Re10M K4, K1, K1, K1; the headline K4, K1, K1; the 400^3
  row K1 (a synthetic level of its shape with a Bouzidi plan: the row's
  host build takes ~40 s).
- Each of the six shipped `CASES/` gives K4 on level 1 and K1 below, on one
  device and on 3 slabs, with no memory limit and at an 80 GB card's
  capacity.
- A single-level sweep row of 63.7M, 37.4M or 10.8M cells, float32 or
  bf16, runs K1 at a capacity its A -> B estimate fits and K5 one byte
  short of it: float32 63.7M too, which the TPU's budgets never let run in
  place.
"""

import os

import numpy as np
import pytest
import torch

from open_ludwig_torch import memory
from open_ludwig_torch import solver_dense as sd
from open_ludwig_torch.checks import case_levels
from open_ludwig_torch.config import load_case_config
from open_ludwig_torch.core.patch import (BC_INLET, BC_MIRROR_Y, BC_MIRROR_Z,
                                          BC_OUTLET, PatchLevel)
from open_ludwig_torch.domain.bouzidi import BouzidiData
from open_ludwig_torch.ops import engine
from open_ludwig_torch.parallel.patch_shard import make_x_mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = (BC_INLET, BC_OUTLET, BC_MIRROR_Y, BC_MIRROR_Y, BC_MIRROR_Z, BC_MIRROR_Z)
CARD = 80 * 10**9  # bytes: about an 80 GB card's memory less its reserve
SHIPPED = {
    "cube": ["flat", "k1", "k1", "k1"],
    "sphere_re10m": ["flat", "k1", "k1", "k1"],
    "sphere_re1m": ["flat", "k1", "k1"],
    "sphere_re266k": ["flat", "k1", "k1"],
    "wing_0deg": ["flat", "k1", "k1"],
    "wing_5deg": ["flat", "k1", "k1"],
}


def _engines(cfg, levels, n, capacity):
    """The statics' engines of `levels` on `n` CPU slabs (one device for 1)."""
    mesh = make_x_mesh(n, "cpu") if n > 1 else None
    statics = sd.build_patch_statics(cfg, levels, "cpu", x_mesh=mesh, capacity=capacity)
    return [st["engine"] for st in statics]


def _row(shape):
    """A single level of `shape` with inlet, outlet and mirror faces and a
    Bouzidi plan of one cell; shape-only fields (the rule reads none)."""
    one = np.zeros(1, np.int32)
    bz = BouzidiData(one, one, one, np.zeros((1, 27), np.float16),
                     np.full((1, 27), -1, np.int32))
    sh = (1, 1, 1)
    return PatchLevel(level_id=1, dx=1.0, tau=0.51, lo=(0, 0, 0), interior=tuple(shape),
                      face_bc=DOMAIN, obstacle=np.zeros(sh, bool),
                      sponge=np.zeros(sh, np.float32),
                      wall_dist=np.full(sh, 10.0, np.float32), bouzidi=bz)


def _rule(levels, precision, capacity):
    """The card's rule on `levels` with no plans in the estimate."""
    return engine.card_engines(
        levels, capacity,
        lambda engs: memory.case_bytes(levels, engs, precision)["device"])


@pytest.mark.parametrize("cell,want", [
    ("sphere_re10m", ["flat", "k1", "k1", "k1"]),
    ("sphere_re1m_bench", ["flat", "k1", "k1"]),
])
def test_cell_engines(cell, want):
    cfg = load_case_config(os.path.join(ROOT, "lbm_bench", "configs", cell))
    _, _, levels = case_levels(cfg)
    for cap in (None, CARD):
        assert _engines(cfg, levels, 1, cap) == want, cap


def test_row_cell_engine():
    """The 400^3 row: one float32 level, finest and a Bouzidi level, K1 with
    its A -> B estimate under the card's capacity."""
    cfg = load_case_config(os.path.join(ROOT, "lbm_bench", "configs", "sphere_64m_row"))
    assert (cfg.num_levels, cfg.precision) == (1, "float32")
    row = _row((400, 400, 400))
    for cap in (None, CARD):
        (eng, why), = _rule([row], cfg.precision, cap)
        assert eng == "k1" and "finest level: K1" in why, why
    assert memory.case_bytes([row], ["k1"], cfg.precision)["device"] < CARD / 4


@pytest.fixture(scope="module", params=sorted(SHIPPED))
def shipped(request):
    cfg = load_case_config(os.path.join(ROOT, "CASES", request.param))
    return request.param, cfg, case_levels(cfg)[2]


def test_shipped_case_engines(shipped):
    name, cfg, levels = shipped
    assert len(levels) == cfg.num_levels
    for n in (1, 3):
        for cap in (None, CARD):
            assert _engines(cfg, levels, n, cap) == SHIPPED[name], (n, cap)


@pytest.mark.parametrize("fits", [True, False], ids=["fits", "one-byte-short"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(432, 384, 384), (320, 304, 384), (232, 216, 216)],
                         ids=["63.7M", "37.4M", "10.8M"])
def test_sweep_row_k1_or_k5(shape, precision, fits):
    row = _row(shape)
    need = memory.case_bytes([row], ["k1"], precision)["device"]
    (eng, why), = _rule([row], precision, need if fits else need - 1)
    if fits:
        assert eng == "k1" and f"A->B {need / 1e9:.1f} GB fits" in why, why
    else:
        assert eng == "inplace" and f"A->B {need / 1e9:.1f} GB exceeds" in why, why
        assert "still exceeds" not in why  # the row fits on K5

"""Device state and static bundles per level of the blocks layout.

Port of `open_ludwig_tpu/core/state.py`.  State per level is a dict
{f, rho, vel} of float32 tensors on one device:
  f:   (27, nb, 512) distributions
  rho: (nb, 512)
  vel: (3, nb, 512)

As in the JAX package there is no f_temp / f_post_collision / persistent
f_old: each sub-step makes new tensors, the Bouzidi correction reads the
uncorrected snapshot, and the temporal-interpolation "old" state is the
parent's pre-step tensors, alive within one coarse step.

The plans' indices live on the device as int64 (`_plan_to_device`), the
index type torch's gathers and scatters take, twice the JAX package's
int32: `hbm_report` counts the bytes the device really holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import lattice as lat
from ..config import CaseConfig
from ..domain.builder import LevelGeometry
from ..scaling import DomainParams
from .plan import StreamPlan, build_bouzidi_plan, build_stream_plan


def init_level_state(geo: LevelGeometry, device="cpu") -> Dict:
    """Rest state: f = w, rho = 1, vel = 0."""
    nb = geo.n_blocks
    dev = torch.device(device)
    w = torch.as_tensor(lat.W, dtype=torch.float32, device=dev)
    return {
        "f": w[:, None, None].expand(27, nb, lat.BLOCK_CELLS).contiguous(),
        "rho": torch.ones((nb, lat.BLOCK_CELLS), dtype=torch.float32, device=dev),
        "vel": torch.zeros((3, nb, lat.BLOCK_CELLS), dtype=torch.float32,
                           device=dev),
    }


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A plan array on the device: integer indices as int64, bool and
    float32 as they are."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, device=device)


def _plan_to_device(plan: StreamPlan, device="cpu") -> Dict:
    out = {key: _to_device(getattr(plan, key), device) for key in (
        "scatter_dst", "scatter_perm", "gather_src", "inlet_k", "inlet_gy",
        "inlet_gz", "outlet_k", "const_val", "parent_k", "parent_idx",
        "parent_valid", "parent_w")}
    out["fneq_rescale"] = plan.fneq_rescale  # python float
    return out


def build_level_static(
    geo: LevelGeometry,
    parent_geo: Optional[LevelGeometry],
    cfg: CaseConfig,
    params: DomainParams,
    device="cpu",
) -> Dict:
    lvl = geo.level_id
    scale = 2 ** (lvl - 1)
    nx_g = params.nx_coarse * scale
    ny_g = params.ny_coarse * scale
    nz_g = params.nz_coarse * scale
    tau_parent = params.tau_levels[lvl - 2] if lvl > 1 else 0.5
    plan = build_stream_plan(geo, parent_geo, tau_parent, nx_g, ny_g, nz_g)

    static = {
        "plan": _plan_to_device(plan, device),
        "obstacle": torch.as_tensor(geo.obstacle, device=device),
        "sponge": torch.as_tensor(geo.sponge, device=device),
        "wall_dist": torch.as_tensor(geo.wall_dist, device=device),
        "vel_dst": tuple(_to_device(d, device) for d in plan.vel_dst),
        "vel_src": tuple(_to_device(s, device) for s in plan.vel_src),
    }
    bz_plan = build_bouzidi_plan(geo, cfg.q_min_threshold)
    static["bouzidi"] = None if bz_plan is None else {
        key: _to_device(getattr(bz_plan, key), device)
        for key in ("dst", "src_k", "src_other", "coef_a", "coef_b")}
    return static


def build_all(cfg: CaseConfig, params: DomainParams, levels: List[LevelGeometry],
              device="cpu"):
    """Returns (states, statics) lists, coarse->fine, on `device`."""
    statics = []
    states = []
    for i, geo in enumerate(levels):
        parent_geo = levels[i - 1] if i > 0 else None
        statics.append(build_level_static(geo, parent_geo, cfg, params, device))
        states.append(init_level_state(geo, device))
    return states, statics


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def hbm_estimate(levels: List[LevelGeometry], statics: List[Dict]):
    """`hbm_report`'s numbers: (rows of (level, state, fields, plan,
    bouzidi bytes), the estimated total, the step transient in it)."""
    rows = []
    total = trans = 0
    for geo, st in zip(levels, statics):
        n = geo.n_cells
        state_b = n * 4 * (27 + 1 + 3)
        plan_b = _nbytes(st["plan"].values()) + _nbytes(st["vel_dst"] + st["vel_src"])
        field_b = _nbytes((st["obstacle"], st["sponge"], st["wall_dist"]))
        bz_b = _nbytes(st["bouzidi"].values()) if st["bouzidi"] else 0
        total += state_b + plan_b + field_b + bz_b
        trans = max(trans, state_b)
        rows.append((geo, state_b, field_b, plan_b, bz_b))
    return rows, total + trans, trans


def hbm_report(levels: List[LevelGeometry], statics: List[Dict]) -> str:
    """Per-level device-memory accounting, the reference's VRAM breakdown
    analogue (reference: src/diagnostics_vram.jl:17-133): the state, the
    static fields, the stream plan (int64 indices, with the face-neighbour
    velocity fix-ups) and the Bouzidi links, as the statics hold them.  A
    sub-step writes a new f, rho and vel while the old ones are alive, and
    a parent's pre-step state lives until its children's sub-steps have
    read it: the transient counted is the largest level's new state (the
    collision's own temporaries come on top).  The graphed runner (the
    default on a card) holds that transient for the whole run instead: the
    captured step allocates its new states and temporaries in the graphs'
    pool and copies the new states back into the first ones.  On CUDA, the
    device's live allocation beside it."""
    rows, total, trans = hbm_estimate(levels, statics)
    lines = ["Device memory (blocks layout, float32; plan indices int64):"]
    for geo, state_b, field_b, plan_b, bz_b in rows:
        lines.append(
            f"  level {geo.level_id}: {geo.n_blocks} blocks, {geo.n_cells/1e6:7.2f}M "
            f"cells | state {state_b/1e6:8.1f} MB | fields {field_b/1e6:6.1f} MB | "
            f"plan {plan_b/1e6:6.1f} MB | bouzidi {bz_b/1e6:5.1f} MB")
    lines.append(f"  estimated total: {total/1e9:.3f} GB (incl. {trans/1e6:.0f} MB "
                 "step transient of the largest level)")
    lines.append("  graphed runner (the default on a card): the step's transient "
                 "and its temporaries stay in the graphs' pool for the run (its "
                 "bytes on the [Graph] log line), each step's new state copied "
                 "back into the first")
    dev = statics[0]["obstacle"].device
    if dev.type == "cuda":
        live = torch.cuda.memory_allocated(dev)
        lines.append(f"  device live: {live/1e9:.3f} GB allocated (estimate/live = "
                     f"{total/max(live, 1):.2f})")
    return "\n".join(lines)

"""The device-memory estimate of a patch case, and the card's capacity.

One policy, read by the card's kernel rule (`ops.engine.card_engines`,
through the callable its callers build from `case_bytes`) and printed by
the reports (`solver_dense.hbm_report_patches`, `parallel.patch_shard.
hbm_report_sharded`):

  - `level_bytes`: a level's resident state and static fields, and its
    second buffers (A -> B: a second f, rho, vel; K5: a second rho, vel and
    its edge buffer's bound, `edge_bound_elems`), each tensor rounded as
    the caching allocator rounds it (`_blocks`).  The graphed runner holds
    every level's second buffers for the whole run, so they add up.
  - `plan_bytes` / `plans_extra`: what a level's plans add: its Bouzidi
    plan, the endpoint slabs it carries for its child (two sets while the
    child's planes are built), its ghost-plane plan and the planes' working
    set (`PLANE_WORK`).
  - `case_bytes`: the case's sum per card, with the matmul workspaces
    (`MATMUL_WORKSPACE`) and the flow statistics' chunk; under an x mesh
    each slab's bytes on its device, so the slabs that share a card add up.
  - `card_capacity`: the card's memory less `CARD_RESERVE_*`, what the
    estimate leaves to what it does not count; `level_capacity`, that
    capacity in cells of one level (`bytes_per_cell`), is what
    `runner.plan_case` and `tools/plan_216m` report.

The estimate counts what torch allocates (`torch.cuda.max_memory_
allocated`); the reserve covers what the card holds beyond it: the caching
allocator's free blocks inside its segments (`torch.cuda.max_memory_
reserved` above the allocated peak) and the CUDA context.  `chip_smoke.py`
holds both against every run it makes (`[memory]`).  Nothing here asks a
backend but `card_capacity`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.patch import BC_INTERFACE, PatchLevel
from .diagnostics import STATS_CHUNK
from .ops import inplace_layout, storage

# what the card's rule leaves free beside the case's estimate: the caching
# allocator's free blocks inside the segments it reserved (the graphs'
# private pools included) and the CUDA context with its modules, which the
# card's total counts and torch does not allocate
CARD_RESERVE_SHARE = 0.05
CARD_RESERVE_MIN = 2 * 2**30
# the caching allocator hands a large tensor a block rounded up to 2 MiB
ALLOC_ROUND = 2 * 2**20
# cuBLAS's workspaces, which the ghost planes' matmuls allocate through the
# caching allocator: 32 MiB on sm_90 (PyTorch's default for Hopper), one
# per stream that runs a matmul, the eager steps' and a graph capture's.
# One was live at the headline's peak (35.4 MB with a matmul output;
# NVIDIA H100 80GB HBM3, `tools/probe_peak_memory.py`)
MATMUL_WORKSPACE = 2 * 32 * 2**20
# the float32 values live while one group of a child's ghost planes is
# built (`ops/dense_step.interface_planes_pair_mm`), per face and sub-step
# weight, at its largest (the rescale): per plane cell (A x B) f_up 27,
# rv_w 36, the equilibrium's cu, usq, expr, feq, up 27 + 9 + 27 + 27 + 27
# and two 27-value temporaries of the rescale; per (wa x B) t 27 and trv
# 12; per slab cell (wa x wb) f_sl 27 and rv 4.  Each name's new tensor
# replaces the previous group's, so only the largest group's set counts
# (the run's peak caught ~100 values a plane cell of it, the headline's;
# NVIDIA H100 80GB HBM3, `tools/probe_peak_memory.py`)
PLANE_WORK = (234, 39, 31)
# `diagnostics.compute_flow_stats`'s temporaries a cell of a chunk (mask,
# |u|^2 and three masked copies, float32)
STATS_BYTES_PER_CELL = 32


def card_capacity(device) -> Optional[int]:
    """The bytes the card's rule may plan for on `device`: the card's total
    memory (`torch.cuda.mem_get_info`) less the reserve (`card_reserve`);
    None (no limit) on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    total = int(torch.cuda.mem_get_info(dev)[1])
    return total - card_reserve(total)


def bytes_per_cell(f_bytes: int, eng: str) -> float:
    """Device bytes a cell of one level on engine `eng` holds, resident and
    second (`level_bytes`)."""
    n = 1 << 30  # every term a whole number of the allocator's blocks
    return sum(level_bytes(n, f_bytes, eng)) / n


def level_capacity(capacity: int, f_bytes: int, eng: str) -> int:
    """Cells of one level on engine `eng` whose bytes (`bytes_per_cell`)
    fit `capacity` bytes: with the card's rule's capacity (`card_capacity`)
    what `runner.plan_case` reports."""
    return int(capacity / bytes_per_cell(f_bytes, eng))


def card_reserve(total: int) -> int:
    """The bytes of a card of `total` bytes that the estimate leaves to the
    allocator's free blocks and the CUDA context: the larger of
    `CARD_RESERVE_SHARE` of it and `CARD_RESERVE_MIN`."""
    return max(int(CARD_RESERVE_SHARE * total), CARD_RESERVE_MIN)


def edge_bound_elems(n_cells: int, f_bytes: int) -> int:
    """An upper bound of K5's edge buffer in storage elements for a level of
    `n_cells` cells on any card: 18 entries per cell of every inner tile
    boundary (one in `ty` rows) and run boundary (one in at least
    `MIN_RUN` planes; `ops/inplace_layout.py`)."""
    ty = inplace_layout.THREADS // (inplace_layout.ROW_BYTES // f_bytes)
    return -(-18 * n_cells * (inplace_layout.MIN_RUN + ty)
             // (ty * inplace_layout.MIN_RUN))


def _blocks(nbytes: int) -> int:
    """`nbytes` as the caching allocator's block: a large tensor's (10 MiB
    and above) rounded up to `ALLOC_ROUND`, a smaller one's to 512 B."""
    step = ALLOC_ROUND if nbytes >= 10 * 2**20 else 512
    return -(-int(nbytes) // step) * step


def level_bytes(n_cells: int, f_bytes: int, eng: str) -> Tuple[int, int]:
    """(resident, second) device bytes of `n_cells` cells of a level on
    engine `eng`.  Resident: 27 f entries, rho and vel (float32), and the
    static fields (obstacle u8, sponge f32, wall distance f32).  Second:
    what the level's steps add while its state is alive, which the graphed
    runner holds for the whole run (its A/B buffers, `solver_dense.
    FixedBuffers`): an A -> B level ("k1", "flat") a second f, rho and vel;
    an in-place level ("inplace", K5) a second rho and vel and the edge
    buffer (`edge_bound_elems`)."""
    n = int(n_cells)
    resident = (_blocks(27 * f_bytes * n) + _blocks(4 * n) + _blocks(12 * n)
                + _blocks(n) + 2 * _blocks(4 * n))
    if eng == "inplace":
        return resident, (_blocks(4 * n) + _blocks(12 * n)
                          + _blocks(edge_bound_elems(n, f_bytes) * f_bytes))
    return resident, _blocks(27 * f_bytes * n) + _blocks(4 * n) + _blocks(12 * n)


def _nbytes(obj) -> int:
    """Bytes of the tensors and arrays in a plan (nested dicts and lists)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def _plane_work(g: Dict) -> int:
    """Bytes of one ghost-plane group's working set (`PLANE_WORK`), both
    sub-step weights."""
    t0, t1 = [a for a in range(3) if a != g["axis"]]
    wa, wb = g["sizes"][t0], g["sizes"][t1]
    per_ab, per_ab_slab, per_slab = PLANE_WORK
    return 4 * len(g["faces"]) * 2 * (per_ab * g["A"] * g["B"]
                                      + per_ab_slab * wa * g["B"] + per_slab * wa * wb)


def plan_bytes(plan: Optional[Dict], own_mm: Optional[Dict], child_mm: Optional[Dict],
               f_bytes: int) -> Tuple[int, int, int]:
    """(Bouzidi, slabs, planes) bytes of a level: its Bouzidi plan (S,
    K2's links and their scratch), the float32 endpoint slabs it carries
    for its child (`child_mm`, the child's ghost-plane plan), once, and its
    own ghost-plane plan (`own_mm`) with the planes (27 values of
    `f_bytes` a plane cell at both sub-step weights) and the largest
    group's working set while they are built (`_plane_work`).  Host arrays
    in the plans are counted too."""
    slab_b = sum(len(g["faces"]) * 31 * g["sizes"][t0] * g["sizes"][t1] * 4
                 for g in (child_mm["groups"] if child_mm else ())
                 for t0, t1 in [[a for a in range(3) if a != g["axis"]]])
    plane_b = 0
    if own_mm is not None:
        groups = own_mm["groups"]
        plane_b = (_nbytes(own_mm)
                   + 27 * f_bytes * sum(len(g["faces"]) * 2 * g["A"] * g["B"]
                                        for g in groups)
                   + max((_plane_work(g) for g in groups), default=0))
    return _nbytes(plan), slab_b, plane_b


def plans_extra(plans: Sequence[Optional[Dict]], mms: Sequence[Optional[Dict]],
                f_bytes: int) -> List[int]:
    """What each level's plans add to the case's estimate (`plan_bytes`):
    the Bouzidi plan, two sets of carried slabs (the new ones are built
    while the old are alive) and the ghost planes."""
    out = []
    for li, plan in enumerate(plans):
        bz_b, slab_b, plane_b = plan_bytes(
            plan, mms[li], mms[li + 1] if li + 1 < len(mms) else None, f_bytes)
        out.append(bz_b + 2 * slab_b + plane_b)
    return out


def case_bytes(patches: Sequence[PatchLevel], engines: Sequence[str], precision: str,
               extra: Optional[Sequence[int]] = None,
               devices: Optional[Sequence] = None,
               bounds: Optional[Sequence[Sequence[int]]] = None) -> Dict[str, int]:
    """The case's device-memory estimate per card (str(device) -> bytes;
    "device" for one unnamed device): every level's `level_bytes` on its
    engine, resident and second alike, plus `extra[l]` (`plans_extra`),
    the matmul workspaces where a level has interface faces, and the flow
    statistics' chunk on the largest level.  With `devices` (an x mesh's,
    one per slab) and `bounds` (each level's slab bounds, `parallel.
    patch_shard.slab_bounds`) each slab adds its cells and its two edge
    planes (f and vel) to its device's sum, so the slabs that share a card
    add up; the rest goes to the first."""
    f_bytes = storage.f_dtype(precision).itemsize
    devs = [str(d) for d in devices] if devices else ["device"]
    out = {d: 0 for d in devs}
    out[devs[0]] += STATS_BYTES_PER_CELL * min(max(p.n_cells for p in patches),
                                               STATS_CHUNK)
    if any(bc == BC_INTERFACE for p in patches for bc in p.face_bc):
        out[devs[0]] += MATMUL_WORKSPACE
    for li, (p, eng) in enumerate(zip(patches, engines)):
        out[devs[0]] += int(extra[li]) if extra is not None else 0
        if len(devs) == 1:
            out[devs[0]] += sum(level_bytes(p.n_cells, f_bytes, eng))
            continue
        _, Y, Z = p.interior
        b = bounds[li]
        for i, d in enumerate(devs):
            cells = (b[i + 1] - b[i]) * Y * Z
            out[d] += sum(level_bytes(cells, f_bytes, eng)) + 2 * Y * Z * (27 * f_bytes + 12)
    return out

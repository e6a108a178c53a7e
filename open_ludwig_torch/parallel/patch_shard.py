"""x-slab execution of the dense-patch multi-level step over several devices.

Counterpart of `open_ludwig_tpu/parallel/patch_shard.py` and of the mesh
branches of the JAX `solver_dense.make_coarse_step_dense` (`mesh=`,
`_shard_map_pstep`, solver_dense.py:105-196, :231-322).  Every level of a
case is cut along x (the streaming axis) into n slabs, one per device of an
`XMesh`: slab i of a level of X planes holds planes [b_i, b_(i+1)) with
b_i = (i X) // n (`slab_bounds`), unpadded, so slabs may differ by one
plane.  Each device holds its slab's f (27, XL, Y, Z), rho and vel and the
matching slices of the static fields.  Per sub-step of a level:

  1. halo exchange (`exchange_edges`): every slab receives the last plane
     of its left neighbour and the first of its right neighbour, f in the
     storage type and vel in float32, into (27, 2, Y, Z) and (3, 2, Y, Z)
     buffers kept per level and slab ([:, 0] left, [:, 1] right; the two
     dead planes at the domain ends stay zero, the x faces overwrite what
     they would give).  Every slab's edges are copied before any slab's
     launch: K5 writes f in place, and on a virtual mesh (several slabs on
     one card) the slabs share one stream;
  2. each slab's launch of its level's kernel in its sharded form (K1, K4
     or K5 with `edges=` and `x_off=`), the level's kernel by the card's
     rule (`ops.engine`) for the slabs' bytes on each card;
  3. on a Bouzidi level, every slab's halo of link sources that lie in
     other slabs gathered first (`bouzidi_halos`), then K2 per slab over
     the links whose written cell it owns (K2's two phases hold across
     slabs: every read is taken before any slab writes);
  4. for a child level, the parent's endpoint slabs assembled from the
     slabs' rows (`endpoint_slabs_sharded`: O(surface) bytes, onto the
     first device), `interface_planes_pair_mm` run unchanged (the same
     shapes, so the same bits), and each child slab given the x range of
     its y- and z-face planes (their A axis is x) and the first and last
     slab the x-face planes.

The temporal blocking pair (K3) is off under a mesh, as in the JAX package
(solver_dense.py:374): its ring reads step A's planes x - 1 .. x + 1 of
its own array, which a slab's ends do not hold.

`slab_schedule` gives `solver_dense.make_coarse_step_dense` these parts
(the sub-step, the endpoint slabs, the planes cut per slab); the schedule
itself, its recursion over the levels and its carried slabs, is that
function's for one device and for a mesh alike.

Nothing else reads the slabs: `runner.solve_case` gathers a level to the
global layout (`gather_states`) where an event needs it (forces and
diagnostics on the first device, checkpoints and flow files on the host),
so forces, statistics and the file formats are one device's.

A mesh is a list of devices: `make_x_mesh(n, "cuda")` takes the first n
visible cards (and raises if fewer are visible), `make_x_mesh(n, "cpu")`
n CPU slabs; `XMesh([torch.device("cuda", 0)] * n)` is a virtual mesh of
n slabs on one card, the port's analogue of the JAX tests' virtual CPU
devices.  Copies between two cards use `Tensor.copy_` across devices;
they are not exercised on a one-card machine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import lattice as lat
from .. import memory
from ..core.patch import BC_INTERFACE, PatchLevel
from ..ops import engine, storage
from ..ops.cuda_step import (
    bouzidi,
    stream_collide,
    stream_collide_flat,
    stream_collide_inplace,
)
from ..ops.dense_step import (
    SELF_LINK,
    build_bouzidi_dense_plan,
    build_iface_mm_plan,
    endpoint_slabs_from,
    iface_mm_plan_to,
)

_FIELDS = (("f", 1), ("rho", 0), ("vel", 1))  # state key, axes before x


class XMesh:
    """An ordered list of devices, one x slab of every level each."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("an x mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def virtual(self) -> bool:
        """Whether several slabs share a device."""
        return len(set(self.devices)) < len(self.devices)

    def __repr__(self) -> str:
        return f"XMesh({[str(d) for d in self.devices]})"


def make_x_mesh(n: int, device="cuda") -> XMesh:
    """An x mesh of n slabs: the first n visible cards for "cuda" (raises
    when fewer are visible, as the JAX make_x_mesh does), n CPU slabs for
    "cpu"."""
    n = int(n)
    if n < 1:
        raise ValueError(f"an x mesh of {n} devices")
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"requested {n} CUDA devices, {have} visible")
        return XMesh([torch.device("cuda", i) for i in range(n)])
    if dev.type == "cpu":
        return XMesh([torch.device("cpu")] * n)
    raise ValueError(f"unsupported device {device!r}")


def slab_bounds(X: int, n: int) -> List[int]:
    """The n + 1 plane bounds of n slabs of X planes: b_i = (i X) // n."""
    if not 1 <= n <= X:
        raise ValueError(f"{n} slabs of a level of {X} planes")
    return [(i * X) // n for i in range(n + 1)]


def _slab_copy(t: torch.Tensor, lead: int, x0: int, x1: int, dev) -> torch.Tensor:
    out = torch.empty(t.shape[:lead] + (x1 - x0,) + t.shape[lead + 1:],
                      dtype=t.dtype, device=dev)
    out.copy_(t.narrow(lead, x0, x1 - x0))
    return out


def shard_states(states: List[Dict], mesh: XMesh) -> List[Dict]:
    """Global level states -> per-slab lists on the mesh's devices (fresh
    copies; derived carries such as "_ifsl" are dropped and re-seeded by
    the runner)."""
    out = []
    for st in states:
        b = slab_bounds(st["rho"].shape[0], mesh.size)
        out.append({key: [_slab_copy(st[key], lead, b[i], b[i + 1], d)
                          for i, d in enumerate(mesh.devices)]
                    for key, lead in _FIELDS})
    return out


def gather_states(states: List[Dict], device) -> List[Dict]:
    """Per-slab level states -> global states on `device` (unsharded states
    are moved as they are); "_" keys are dropped."""
    out = []
    for st in states:
        if not isinstance(st["f"], (list, tuple)):
            out.append({key: st[key].to(device) for key, _ in _FIELDS})
            continue
        out.append({key: torch.cat([p.to(device) for p in st[key]], dim=lead)
                    for key, lead in _FIELDS})
    return out


def init_states_sharded(patches: List[PatchLevel], precision: str,
                        mesh: XMesh) -> List[Dict]:
    """Rest states (f = w or g = 0, rho = 1, vel = 0) of every slab."""
    bf16 = storage.f_dtype(precision) == torch.bfloat16
    out = []
    for p in patches:
        X, Y, Z = p.interior
        b = slab_bounds(X, mesh.size)
        st = {"f": [], "rho": [], "vel": []}
        for i, d in enumerate(mesh.devices):
            sh = (b[i + 1] - b[i], Y, Z)
            if bf16:
                f = torch.zeros((27,) + sh, dtype=torch.bfloat16, device=d)
            else:
                W = torch.as_tensor(lat.W, device=d)
                f = W.reshape(27, 1, 1, 1).expand((27,) + sh).contiguous()
            st["f"].append(f)
            st["rho"].append(torch.ones(sh, dtype=torch.float32, device=d))
            st["vel"].append(torch.zeros((3,) + sh, dtype=torch.float32, device=d))
        out.append(st)
    return out


# ---- static fields, Bouzidi links per slab ----

def _split_links(links: Dict[str, np.ndarray], level, bounds: List[int]) -> List[Dict]:
    """The plan's K2 links split by the slab that owns the written cell,
    cells and sources slab-local: a source in another slab becomes src =
    -1 - h, h its entry in the slab's halo, ordered by the slab it comes
    from ("halo": per source slab o, its flat element indices into slab
    o's f, numpy int64)."""
    _, Y, Z = level
    YZ = Y * Z
    b = np.asarray(bounds)
    cell = links["cell"].astype(np.int64)
    src = links["src"].astype(np.int64)
    code = links["code"]
    j = (code & 31).astype(np.int64)
    slot = np.where(code >= SELF_LINK, j, 26 - j)
    own_cell = np.searchsorted(b, cell // YZ, side="right") - 1
    own_src = np.searchsorted(b, src // YZ, side="right") - 1
    out = []
    for i in range(len(b) - 1):
        sel = np.nonzero(own_cell == i)[0]
        if len(sel) == 0:
            out.append(None)
            continue
        x0 = int(b[i])
        s_src = src[sel] - x0 * YZ
        halo = {}
        h = 0
        for o in range(len(b) - 1):
            far = np.nonzero(own_src[sel] == o)[0] if o != i else np.zeros(0, np.int64)
            if len(far) == 0:
                continue
            xo0, xo1 = int(b[o]), int(b[o + 1])
            g = sel[far]
            halo[o] = slot[g] * ((xo1 - xo0) * YZ) + (src[g] - xo0 * YZ)
            s_src[far] = -1 - (h + np.arange(len(far)))
            h += len(far)
        out.append({
            "cell": (cell[sel] - x0 * YZ).astype(np.int32),
            "code": code[sel],
            "src": s_src.astype(np.int32),
            "a": links["a"][sel],
            "halo": halo,
            "n_halo": h,
        })
    return out


def shard_bouzidi_plan(plan: Dict, bounds: List[int], devices) -> List[Optional[Dict]]:
    """Per slab of `bounds`, K2's plan of the links whose written cell it
    owns (`_split_links`; numpy or device links in), its tensors on its
    device: "links" (cell, code, src, a and a float32 scratch), "level"
    (XL, Y, Z), "n_halo" and "halo" ((source slab, flat index tensor on
    that slab's device) pairs, for `bouzidi_halos`); None for a slab
    without links."""
    links = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
             for key, v in plan["links"].items() if key != "scratch"}
    _, Y, Z = plan["level"]
    out = []
    for i, pt in enumerate(_split_links(links, plan["level"], bounds)):
        if pt is None:
            out.append(None)
            continue
        d = devices[i]
        lk = {key: torch.as_tensor(pt[key], device=d)
              for key in ("cell", "code", "src", "a")}
        lk["scratch"] = torch.empty(lk["a"].shape, dtype=torch.float32, device=d)
        out.append({"lo": plan["lo"], "dim": plan["dim"],
                    "level": (bounds[i + 1] - bounds[i], Y, Z), "links": lk,
                    "n_halo": pt["n_halo"],
                    "halo": [(o, torch.as_tensor(idx, device=devices[o]))
                             for o, idx in pt["halo"].items()]})
    return out


def shard_statics(cfg, patches: List[PatchLevel], mesh: XMesh,
                  capacity: Optional[int] = None) -> List[Dict]:
    """Per level, the statics of the mesh's slabs:

      "engine", "engine_why"  the level's kernel by the card's rule
                              (`engine.card_engines`) for the mesh's slabs
                              and `capacity` bytes a card (None: the first
                              card's own, `memory.card_capacity`; no limit
                              on the CPU): the slabs that share a card add
                              up there
      "bounds"                its slab bounds (`slab_bounds`)
      "iface_mm"              its ghost-plane plan against its parent, on
                              the first device (None on level 1)
      "bouzidi"               the level's Bouzidi plan (numpy) or None
      "shards"                per slab: obstacle, sponge, wall_dist (XL, Y,
                              Z) on its device, "x_off", and "bouzidi": its
                              K2 plan (links on its device with their
                              scratch, "level" (XL, Y, Z), "halo": (source
                              slab, flat index tensor on that slab's
                              device) pairs) or None"""
    n = mesh.size
    dev0 = mesh.devices[0]
    if capacity is None:
        capacity = memory.card_capacity(dev0)
    plans = [build_bouzidi_dense_plan(p, cfg.q_min_threshold) for p in patches]
    mms = [iface_mm_plan_to(build_iface_mm_plan(p, patches[li - 1]), dev0)
           if li > 0 else None for li, p in enumerate(patches)]
    bounds = [slab_bounds(p.interior[0], n) for p in patches]
    extra = memory.plans_extra(plans, mms, storage.f_dtype(cfg.precision).itemsize)
    card = engine.card_engines(
        patches, capacity,
        lambda engs: max(memory.case_bytes(patches, engs, cfg.precision, extra,
                                           mesh.devices, bounds).values()))
    out = []
    for li, (p, (eng, why)) in enumerate(zip(patches, card)):
        b = bounds[li]
        plan = plans[li]
        parts = (shard_bouzidi_plan(plan, b, mesh.devices) if plan is not None
                 else [None] * n)
        shards = []
        for i, d in enumerate(mesh.devices):
            x0, x1 = b[i], b[i + 1]
            shards.append({
                "obstacle": torch.as_tensor(p.obstacle[x0:x1], dtype=torch.bool,
                                            device=d),
                "sponge": torch.as_tensor(p.sponge[x0:x1], dtype=torch.float32, device=d),
                "wall_dist": torch.as_tensor(p.wall_dist[x0:x1], dtype=torch.float32,
                                             device=d),
                "x_off": x0,
                "bouzidi": parts[i],
            })
        out.append({
            "engine": eng, "engine_why": why, "bounds": b,
            "iface_mm": mms[li],
            "bouzidi": plan,
            "shards": shards,
        })
    return out


# ---- the halo exchange, Bouzidi halos, ghost planes ----

def edge_buffers(patch: PatchLevel, bounds: List[int], devices, dtype) -> List:
    """One level's (f_edges (27, 2, Y, Z) `dtype`, v_edges (3, 2, Y, Z)
    float32) per slab, zero (the dead planes at the domain ends stay so)."""
    _, Y, Z = patch.interior
    return [(torch.zeros((27, 2, Y, Z), dtype=dtype, device=d),
             torch.zeros((3, 2, Y, Z), dtype=torch.float32, device=d))
            for d in devices[:len(bounds) - 1]]


def exchange_edges(f_parts: List[torch.Tensor], v_parts: List[torch.Tensor],
                   bufs: List) -> List:
    """Copy every slab's neighbour planes into its edge buffers: [:, 0] the
    previous slab's last plane, [:, 1] the next slab's first; returns
    `bufs`.  All copies are issued before the caller launches any slab."""
    n = len(f_parts)
    for i, (fe, ve) in enumerate(bufs):
        if i > 0:
            fe[:, 0].copy_(f_parts[i - 1][:, -1])
            ve[:, 0].copy_(v_parts[i - 1][:, -1])
        if i + 1 < n:
            fe[:, 1].copy_(f_parts[i + 1][:, 0])
            ve[:, 1].copy_(v_parts[i + 1][:, 0])
    return bufs


def bouzidi_halos(shards: List[Dict], f_parts: List[torch.Tensor]) -> List:
    """Per slab with Bouzidi links, the uncorrected values its links read in
    other slabs (1-D, storage type, on its device; empty where none), else
    None.  Taken from every slab before any slab's correction."""
    out = []
    for i, sh in enumerate(shards):
        plan = sh["bouzidi"]
        if plan is None:
            out.append(None)
            continue
        dev = f_parts[i].device
        parts = [f_parts[o].reshape(-1).index_select(0, idx).to(dev)
                 for o, idx in plan["halo"]]
        out.append(parts[0] if len(parts) == 1 else
                   torch.cat(parts) if parts else
                   torch.empty(0, dtype=f_parts[i].dtype, device=dev))
    return out


def _pieces(parts: List[torch.Tensor], bounds: List[int], lead: int, x0: int,
            x1: int):
    """(slab, local start, length) of the slabs overlapping [x0, x1)."""
    for i in range(len(parts)):
        lo, hi = max(x0, bounds[i]), min(x1, bounds[i + 1])
        if lo < hi:
            yield i, lo - bounds[i], hi - lo


def endpoint_slabs_sharded(plan: Dict, state: Dict, bounds: List[int], device
                           ) -> List[Dict]:
    """`dense_step.extract_endpoint_slabs` of a sharded parent state, on
    `device`: each group's window assembled from the rows its slabs own (an
    x-face group's selected planes, a y- or z-face group's x range, each
    piece narrowed and index-selected on its own device first), so the
    same tensors as one device's, O(surface) bytes moved."""
    def window(grp, key, lead):
        parts = state[key]
        ax = grp["axis"]
        t0, t1 = [a for a in range(3) if a != ax]
        sA, sB = grp["starts"][0][t0], grp["starts"][0][t1]
        wa, wb = grp["sizes"][t0], grp["sizes"][t1]
        if ax == 0:  # planes of x picked by idx, y and z narrowed
            sel = []
            for x in grp["idx_list"]:
                (i, loc, _), = _pieces(parts, bounds, lead, x, x + 1)
                p = parts[i].narrow(lead + 1, sA, wa).narrow(lead + 2, sB, wb)
                sel.append(p.narrow(lead, loc, 1).to(device))
            return torch.cat(sel, dim=lead)
        # t0 is x: the x range [sA, sA + wa) from its slabs
        sel = []
        for i, loc, ln in _pieces(parts, bounds, lead, sA, sA + wa):
            p = parts[i].narrow(lead, loc, ln).narrow(lead + t1, sB, wb)
            idx = grp["idx"].to(p.device)
            sel.append(p.index_select(lead + ax, idx).to(device))
        return sel[0] if len(sel) == 1 else torch.cat(sel, dim=lead)

    return endpoint_slabs_from(plan, window, state["f"][0].dtype == torch.bfloat16)


def slab_planes(planes: Dict[int, torch.Tensor], patch: PatchLevel,
                bounds: List[int], devices) -> List[Dict[int, torch.Tensor]]:
    """A child level's ghost planes, face -> (nw, 27, A, B), cut per slab:
    the y and z faces' [:, :, x0:x1] (their A axis is x), contiguous on the
    slab's device; the x-min face to the first slab, x-max to the last."""
    n = len(bounds) - 1
    out = []
    for i in range(n):
        d = {}
        for fc, pl in planes.items():
            if fc == 0 and i != 0 or fc == 1 and i != n - 1:
                continue
            if fc >= 2:
                pl = pl.narrow(2, bounds[i], bounds[i + 1] - bounds[i])
            d[fc] = pl.to(devices[i]).contiguous()
        out.append(d)
    return out


# ---- the parts of the coarse step that differ under a mesh ----

_STEPS = {"k1": stream_collide, "flat": stream_collide_flat,
          "inplace": stream_collide_inplace}


def slab_schedule(patches: List[PatchLevel], statics: List[Dict], mesh: XMesh,
                  dtype: torch.dtype, kw: Dict, out_of=None):
    """The parts of `solver_dense.make_coarse_step_dense`'s schedule that
    differ over the slabs of `mesh` (statics from `shard_statics`, states
    per slab in `dtype`), as (level_step, endpoint_slabs, cut_planes,
    f_dtype):

      level_step(st, lvl, u, seed, iface) -> st   the halo exchange, every
          slab's launch of the level's kernel in its sharded form, then on
          a Bouzidi level the halos and K2 per slab (module docstring);
      endpoint_slabs(lvl, st)   a parent level's endpoint slabs assembled
          from its slabs' rows on the first device;
      cut_planes(lvl, planes) -> (per-slab sub-step A planes, B planes)
          of child level `lvl` (`slab_planes`);
      f_dtype(st)   the storage type of a level state.
    With `out_of` (`solver_dense.FixedBuffers.out_of`) every slab's step
    writes into the partners of its inputs (the graphed runner's fixed
    buffers); the edge buffers are the schedule's own, allocated once."""
    dev0 = mesh.devices[0]
    plans = [st["iface_mm"] for st in statics]
    bufs = [edge_buffers(p, st["bounds"], mesh.devices, dtype)
            for p, st in zip(patches, statics)]

    def level_step(st, lvl, u, seed, iface):
        stat = statics[lvl]
        step = _STEPS[stat["engine"]]
        edges = exchange_edges(st["f"], st["vel"], bufs[lvl])
        outs = []
        for i, sh in enumerate(stat["shards"]):
            kwi = {"iface": iface[i]} if iface is not None else {}
            if out_of is not None:
                kwi["out"] = (None if stat["engine"] == "inplace" else
                              out_of(st["f"][i]), out_of(st["rho"][i]),
                              out_of(st["vel"][i]))
            outs.append(step(st["f"][i], st["vel"][i], u, seed, sh, patches[lvl],
                             edges=edges[i], x_off=sh["x_off"], **kwi, **kw))
        f_new = [o[0] for o in outs]
        if stat["bouzidi"] is not None:
            halos = bouzidi_halos(stat["shards"], f_new)
            f_new = [bouzidi(f, sh["bouzidi"], h, inplace=out_of is not None)
                     if sh["bouzidi"] is not None else f
                     for f, sh, h in zip(f_new, stat["shards"], halos)]
        return {"f": f_new, "rho": [o[1] for o in outs], "vel": [o[2] for o in outs]}

    def endpoint_slabs(lvl, st):
        return endpoint_slabs_sharded(plans[lvl + 1], st, statics[lvl]["bounds"], dev0)

    def cut_planes(lvl, planes):
        cut = slab_planes(planes, patches[lvl], statics[lvl]["bounds"], mesh.devices)
        return ([{fc: pl[0] for fc, pl in d.items()} for d in cut],
                [{fc: pl[-1] for fc, pl in d.items()} for d in cut])

    return level_step, endpoint_slabs, cut_planes, lambda st: st["f"][0].dtype


# ---- reports ----

def kernel_log_lines_sharded(patches: List[PatchLevel], statics: List[Dict],
                             precision: str, mesh: XMesh) -> List[str]:
    """Per level: its slabs, the sharded kernel its sub-steps run and why,
    K2 per slab (links and halo values), and why no K3."""
    bf16 = storage.f_dtype(precision) == torch.bfloat16
    names = {"k1": "K1 stream_collide", "flat": "K4 stream_collide_flat",
             "inplace": "K5 stream_collide_inplace (in place)"}
    route = "CUDA" if mesh.devices[0].type == "cuda" else "plain torch (CPU)"
    lines = [f"  [engine] x mesh of {mesh.size} slabs on "
             + ", ".join(map(str, mesh.devices))
             + (" (virtual: slabs share a device)" if mesh.virtual else "")
             + " | K3 off: the fused pair's ring reads step A's planes x-1..x+1 "
             "of its own array, which a slab's ends do not hold (the JAX "
             "package turns it off under a mesh too, solver_dense.py:374)"]
    for p, st in zip(patches, statics):
        b = st["bounds"]
        n_if = sum(bc == BC_INTERFACE for bc in p.face_bc)
        bz = [sh["bouzidi"] for sh in st["shards"]]
        lines.append(
            f"  [engine] level {p.level_id}: {'x'.join(map(str, p.interior))} cells "
            f"in x slabs " + " ".join(f"[{b[i]},{b[i + 1]})" for i in range(len(b) - 1))
            + f" | {names[st['engine']]} sharded form {route}, "
            f"{'bf16 g-native' if bf16 else 'float32'}, {n_if} interface face(s): "
            f"{st['engine_why']}"
            + (" | K2 bouzidi sharded form per slab, links/halo values "
               + " ".join("-" if z is None else
                          f"{z['links']['a'].shape[0]}/{z['n_halo']}" for z in bz)
               if st["bouzidi"] is not None else ""))
    return lines


def hbm_report_sharded(patches: List[PatchLevel], statics: List[Dict],
                       precision: str, mesh: XMesh) -> str:
    """Device memory per slab and per device (`memory.case_bytes`, which the
    card's rule reads): each slab's resident state and static fields, its
    two edge planes, and its second buffers (A -> B: f, rho, vel; K5: rho,
    vel and its edge buffer's bound), which the graphed runner holds for
    every slab, so the slabs that share a device add up; the plans
    (`memory.plans_extra`) on the first device."""
    f_bytes = 2 if storage.f_dtype(precision) == torch.bfloat16 else 4
    lines = [f"Device memory (x mesh of {mesh.size} slabs, {precision} f-storage):"]
    for p, st in zip(patches, statics):
        _, Y, Z = p.interior
        b = st["bounds"]
        cells = [(b[i + 1] - b[i]) * Y * Z for i in range(len(b) - 1)]
        res, sec = memory.level_bytes(max(cells), f_bytes, st["engine"])
        lines.append(f"  level {p.level_id}: slabs of "
                     + "/".join(f"{c / 1e6:.2f}M" for c in cells) + " cells, "
                     + f"{res / 1e6:.1f} MB resident + {sec / 1e6:.1f} MB second "
                     "buffers on the largest")
    extra = memory.plans_extra([st["bouzidi"] for st in statics],
                               [st["iface_mm"] for st in statics], f_bytes)
    per_dev = memory.case_bytes(patches, [st["engine"] for st in statics], precision,
                                extra, mesh.devices, [st["bounds"] for st in statics])
    for key in sorted(per_dev):
        lines.append(f"  {key}: {per_dev[key] / 1e9:.3f} GB estimated ("
                     f"{sum(str(d) == key for d in mesh.devices)} slab(s))")
    return "\n".join(lines)

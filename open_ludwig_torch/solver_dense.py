"""Multi-level scheduler for the dense-patch layout.

Port of the single-device schedule of
`open_ludwig_tpu/solver_dense.py:make_coarse_step_dense` (the "real"
interface path, :426-631) and of its batch runner (:660-704): level l
advances 2^(l-1) sub-steps per coarse step (reference:
src/solver_control.jl:21-143).  After each parent step the child's ghost
planes for both of its sub-steps (temporal weights 0.0 and 0.5) come from
the reference's Pallas-path pipeline (solver_dense.py:478-520 there): a
static plan per child level (`dense_step.build_iface_mm_plan`, kept in
statics[l]["iface_mm"]), the parent's endpoint slabs extracted once per
parent step (`extract_endpoint_slabs`) and carried under the parent
state's "_ifsl" key as the next step's old ones, and one batched
contraction + elementwise tail per axis group
(`interface_planes_pair_mm`): one (nw, 27, A, B) tensor per face,
pre-shifted, in the child's storage type (bf16 g = f - w planes on bf16
levels, float32 f planes otherwise), whose plane[n] sub-step n reads.

Each level's kernel is the card's choice (`ops.engine.card_engines`, from
its faces, whether it is the finest or a Bouzidi level, and the case's
memory estimate against the card's), recorded as statics[l]["engine"]:
  - "k1": K1 (`ops.cuda_step.stream_collide`) on a level with interface
    faces, and on an interface-free finest or Bouzidi level;
  - "flat": K4 (`ops.cuda_step.stream_collide_flat`) on every other
    interface-free level (level 1 of a multi-level case);
  - "inplace": K5 (`ops.cuda_step.stream_collide_inplace`) on an
    interface-free level where the case's A -> B steps do not fit the
    card: f is updated in its own buffer, and the level takes no K3.
Every sub-step is one launch of its level's kernel, followed on the
finest level by K2 (`ops.cuda_step.bouzidi`): the default (`fuse2=False`),
since K1 -> K2 -> K1 beat K3 pairs at every shape measured on the H100.
Temporal blocking (`fuse2=True`, the JAX package's schedule): a childless
finest "k1" level runs each pair of sub-steps as one K3 launch
(`ops.cuda_step.fused_pair`: step A, A's Bouzidi correction, step B) and
one K2 launch after it; a single-level case runs pairs of coarse steps so
(`coarse_step.pair_step`), an odd batch taking one plain step first.
A child build of the ghost planes is two CUDA kernels on the card
(`ops.ghost_planes`: the endpoint slabs' extraction, then the planes; the
graphed runner's carry adds one copy) and the plain versions on the CPU
(`ghost_slabs`, `ghost_planes_of`).  States are {f: (27, X, Y, Z), rho,
vel} in the storage dtype (float32 f or bf16 g = f - w) on every level, and a
parent level's also "_ifsl", its carried slabs.  K1, K3 and K4 write
fresh buffers (A -> B); a parent's pre-step state has no consumer after
its launch (its old slabs are carried, or taken before the launch on an
unseeded call, which a K5 parent, writing f in place, needs).

With `x_mesh` (`parallel.patch_shard.XMesh`) every level is cut along x
over the mesh's devices, the JAX package's `mesh=` path: statics from
`build_patch_statics(..., x_mesh=)` (per-slab, `shard_statics`), states
per slab (`shard_states`), each sub-step the halo exchange and every
slab's launch of its kernel's sharded form, fuse2 off; the schedule is
the one above, with the parts that differ from `parallel.patch_shard.
slab_schedule`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import lattice as lat
from .config import CaseConfig
from .core.patch import BC_INTERFACE, PatchLevel
from . import memory
from .ops import engine, ghost_planes, storage
from .ops.cuda_step import (
    bouzidi,
    flat_choice,
    fused_pair,
    stream_collide,
    stream_collide_flat,
    stream_collide_inplace,
)
from .ops.dense_step import (
    bouzidi_plan_to,
    build_bouzidi_dense_plan,
    build_iface_mm_plan,
    extract_endpoint_slabs,
    iface_mm_plan_to,
    interface_planes_pair_mm,
)
from .scaling import DomainParams
from .solver import ramp_velocity
from .spans import count, span

def init_patch_state(patch: PatchLevel, precision: str = "float32",
                     device="cpu") -> Dict:
    """Rest state: f = w (float32) or g = 0 (bf16), rho = 1, vel = 0."""
    sh = tuple(patch.interior)
    if storage.f_dtype(precision) == torch.bfloat16:
        f = torch.zeros((27,) + sh, dtype=torch.bfloat16, device=device)
    else:
        W = torch.as_tensor(lat.W, device=device)
        f = W.reshape(27, 1, 1, 1).expand((27,) + sh).contiguous()
    return {
        "f": f,
        "rho": torch.ones(sh, dtype=torch.float32, device=device),
        "vel": torch.zeros((3,) + sh, dtype=torch.float32, device=device),
    }


def build_patch_statics(cfg: CaseConfig, patches: List[PatchLevel],
                        device="cpu", x_mesh=None,
                        capacity: Optional[int] = None) -> List[Dict]:
    """Per level: obstacle (bool), sponge, wall_dist as (X, Y, Z) device
    tensors, the Bouzidi plan (S, the link list and its scratch as device
    tensors: `dense_step.bouzidi_plan_to`) or None, the level's ghost-plane
    plan against its parent ("iface_mm": `dense_step.build_iface_mm_plan`
    with its device tensors, `iface_mm_plan_to`; None on level 1), and
    the level's kernel ("engine", by the card's rule `engine.card_engines`
    for `capacity` bytes a card) with the reason for it ("engine_why").
    `capacity` None is the card's own (`memory.card_capacity`) on CUDA and
    no limit on the CPU.  With `x_mesh`, the per-slab statics of its
    devices (`parallel.patch_shard.shard_statics`; `device` is not read).
    Span `build.statics`."""
    with span("build.statics"):
        return _build_statics(cfg, patches, device, x_mesh, capacity)


def _build_statics(cfg: CaseConfig, patches: List[PatchLevel], device, x_mesh,
                   capacity: Optional[int]) -> List[Dict]:
    if x_mesh is not None:
        from .parallel.patch_shard import shard_statics
        return shard_statics(cfg, patches, x_mesh, capacity)
    if capacity is None:
        capacity = memory.card_capacity(device)
    plans = [bouzidi_plan_to(build_bouzidi_dense_plan(p, cfg.q_min_threshold), device)
             for p in patches]
    mms = [iface_mm_plan_to(build_iface_mm_plan(p, patches[li - 1]), device)
           if li > 0 else None for li, p in enumerate(patches)]
    extra = memory.plans_extra(plans, mms, storage.f_dtype(cfg.precision).itemsize)
    card = engine.card_engines(
        patches, capacity,
        lambda engs: memory.case_bytes(patches, engs, cfg.precision, extra)["device"])
    statics = []
    for p, plan, mm, (eng, why) in zip(patches, plans, mms, card):
        statics.append({
            "obstacle": torch.as_tensor(p.obstacle, dtype=torch.bool, device=device),
            "sponge": torch.as_tensor(p.sponge, dtype=torch.float32, device=device),
            "wall_dist": torch.as_tensor(p.wall_dist, dtype=torch.float32,
                                         device=device),
            "bouzidi": plan,
            "iface_mm": mm,
            "engine": eng,
            "engine_why": why,
        })
    return statics


# why the finest level's sub-step pairs take no K3 by default, from the
# turns of `tools/probe_sweep_rows.py` and `chip_smoke.py` phase 4b (NVIDIA
# H100 80GB HBM3, 700 W): a K3 pair costs more than K1 -> K2 -> K1 at every
# shape measured
NO_K3_WHY = ("K3 no: unfused by default on this card (K1 -> K2 took "
             "0.063-0.066 ns a cell a coarse step on the sweep rows, K3 pairs "
             "0.079-0.125; a K3 pair 0.2765 ms against K1 -> K2 -> K1's "
             "0.13-0.19 on the bench's level 3, H100); fuse2=True runs the JAX "
             "package's pairs")


def kernel_log_lines(patches: List[PatchLevel], statics: List[Dict],
                     precision: str, device, x_mesh=None,
                     fuse2: bool = False) -> List[str]:
    """Per level: the kernel its sub-steps run and why, and
    whether its sub-step pairs take K3 under `fuse2` (and why not); with
    `x_mesh`, per slab (`parallel.patch_shard.kernel_log_lines_sharded`)."""
    if x_mesh is not None:
        from .parallel.patch_shard import kernel_log_lines_sharded
        return kernel_log_lines_sharded(patches, statics, precision, x_mesh)
    dev = torch.device(device)
    route = "CUDA" if dev.type == "cuda" else "plain torch (CPU)"
    store = ("bf16 g-native" if storage.f_dtype(precision) == torch.bfloat16
             else "float32")
    last = len(patches) - 1
    names = {"k1": "K1 stream_collide", "flat": "K4 stream_collide_flat",
             "inplace": "K5 stream_collide_inplace (in place)"}
    lines = []
    for li, (p, st) in enumerate(zip(patches, statics)):
        n_if = sum(bc == BC_INTERFACE for bc in p.face_bc)
        bz = st["bouzidi"]
        eng = st["engine"]
        if li < last:
            k3 = (f"K3 no: parent of level {patches[li + 1].level_id} (its "
                  "state after each sub-step feeds the child's ghost planes)")
        elif eng != "k1":
            k3 = (f"K3 no: {names[eng].split()[0]} runs one sub-step per "
                  "launch, as the reference's kernel for this level does")
        elif not fuse2:
            k3 = NO_K3_WHY
        elif last == 0:
            k3 = (f"K3 fused_pair {route} on pairs of coarse steps (an odd "
                  "batch takes one K1 step first), K2 after each pair")
        else:
            k3 = (f"K3 fused_pair {route} on its {2 ** (p.level_id - 2)} "
                  "sub-step pair(s), K2 after each pair")
        shape = ""
        if eng == "flat" and dev.type == "cuda":
            c = flat_choice(p, storage.f_dtype(precision) == torch.bfloat16)
            shape = (f" ({c['threads']} threads a block, launch bounds for "
                     f"{c['min_blocks']} a SM)")
        mm = st["iface_mm"]
        ghost = (f" | ghost planes: einsum plan, {len(mm['groups'])} groups, "
                 + ("bf16 g-space" if store.startswith("bf16") else "f32 f-space")
                 + (", 2 CUDA kernels a child build" if dev.type == "cuda"
                    else ", plain torch (CPU)")
                 if mm is not None else "")
        lines.append(
            f"  [engine] level {p.level_id}: {'x'.join(map(str, p.interior))} "
            f"cells, {2 ** (p.level_id - 1)} sub-step(s)/coarse step | "
            f"{names[eng]}{shape} {route}, {store}, {n_if} interface face(s): "
            f"{st['engine_why']}"
            + (f" | K2 bouzidi {route}, box {tuple(bz['dim'])} at {bz['lo']}"
               if bz is not None else "")
            + ghost + f" | {k3}"
        )
    return lines


def make_coarse_step_dense(cfg: CaseConfig, params: DomainParams,
                           patches: List[PatchLevel], statics: List[Dict],
                           fuse2: bool = False, x_mesh=None, fixed=None):
    """coarse_step(states, t) -> states advancing every level by one coarse
    step without any host synchronisation.  Each sub-step is one launch of
    its level's kernel (statics[l]["engine"]: "k1" / "flat" / "inplace"),
    followed on the finest level by K2.  With `fuse2` (the JAX package's
    schedule; off by default) the sub-step pairs of a finest "k1" level are
    K3 launches instead.  `coarse_step.pair_step(
    states, t)` runs coarse steps t and t + 1 of such a single-level case
    as one K3 + K2 (None otherwise).  `coarse_step.seed_slabs(states)`
    stores each parent level's endpoint slabs under "_ifsl" (idempotent);
    a parent state without them has its old slabs extracted before its
    launch.  With `x_mesh` the states and statics are per slab, and the
    sub-step, the endpoint slabs and the child's planes are the slabs'
    (`parallel.patch_shard.slab_schedule`), fuse2 off as in the JAX
    package under a mesh; the schedule is the same.

    With `fixed` (a `FixedBuffers`) the step is the graphed runner's: every
    kernel reads its inlet speed and seed from `fixed.record` (a
    `solver.StepRecord` at the coarse step's t, advanced by the step:
    by 1, by 2 in `pair_step`), writes into the partner buffers of its
    inputs (`fixed.out_of`), and a parent's new endpoint slabs are copied
    into its carried ones after its child's planes are built
    (`fixed.carry`): the same launches on the same values at addresses that
    stay fixed from step to step."""
    n_levels = len(patches)
    last = n_levels - 1
    engs = [st["engine"] for st in statics]
    plans = [st["iface_mm"] for st in statics]
    use_temporal = cfg.temporal_interpolation
    kw = dict(
        c_wale=cfg.c_wale,
        nu_sgs_background=cfg.nu_sgs_background,
        inlet_turbulence=cfg.inlet_turbulence_intensity,
        wall_model=cfg.wall_model_enabled,
        sponge_blend=cfg.sponge_blend_distributions,
    )
    iface_free_steps = {"flat": stream_collide_flat,
                        "inplace": stream_collide_inplace}
    record = fixed.record if fixed is not None else None
    out_of = fixed.out_of if fixed is not None else None

    def outs(st: Dict, lvl: int):
        """The preallocated outputs of a step of level `lvl` on `st` (None:
        allocated; an in-place level's f is its input)."""
        if out_of is None:
            return None
        return (None if engs[lvl] == "inplace" else out_of(st["f"]),
                out_of(st["rho"]), out_of(st["vel"]))

    def level_step(st: Dict, lvl: int, u, seed: int, iface) -> Dict:
        """One sub-step of level `lvl`: its kernel, then its K2."""
        if engs[lvl] == "k1":
            f_new, rho_new, vel_new = stream_collide(
                st["f"], st["vel"], u, seed, statics[lvl], patches[lvl],
                iface=iface, out=outs(st, lvl), **kw)
        else:
            f_new, rho_new, vel_new = iface_free_steps[engs[lvl]](
                st["f"], st["vel"], u, seed, statics[lvl], patches[lvl],
                out=outs(st, lvl), **kw)
        plan = statics[lvl]["bouzidi"]
        if plan is not None:
            f_new = bouzidi(f_new, plan, inplace=fixed is not None)
        return {"f": f_new, "rho": rho_new, "vel": vel_new}

    def endpoint_slabs(lvl: int, st: Dict):
        return ghost_slabs(plans[lvl + 1], st)

    def cut_planes(lvl: int, planes: Dict):
        return ({fc: pl[0] for fc, pl in planes.items()},
                {fc: pl[-1] for fc, pl in planes.items()})

    def f_dtype(st: Dict) -> torch.dtype:
        return st["f"].dtype

    if x_mesh is not None:
        from .parallel.patch_shard import slab_schedule
        level_step, endpoint_slabs, cut_planes, f_dtype = slab_schedule(
            patches, statics, x_mesh, storage.f_dtype(cfg.precision), kw,
            out_of=out_of)
        fuse2 = False
    fuse_last = bool(fuse2) and engs[last] == "k1"

    def fused(states: List[Dict], lvl: int, u, seeds, if_a, if_b) -> None:
        """Sub-steps A and B of level `lvl` as one K3, then B's K2."""
        st = states[lvl]
        plan = statics[lvl]["bouzidi"]
        f_new, rho_new, vel_new = fused_pair(
            st["f"], st["vel"], u, seeds, statics[lvl], patches[lvl], plan,
            iface_a=if_a, iface_b=if_b, out=outs(st, lvl), **kw,
        )
        if plan is not None:
            f_new = bouzidi(f_new, plan, inplace=fixed is not None)
        states[lvl] = {"f": f_new, "rho": rho_new, "vel": vel_new}

    def sub_step(t: int, lvl: int, k: int):
        """(u, seed) of sub-step k of level `lvl` at coarse step t: the
        numbers, or the step record's entry (t is the record's then)."""
        if record is not None:
            return record.ref(0, lvl, k), None
        return (ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps),
                ((t << lvl) + k) % 1000000)

    def own(states: List[Dict]) -> List[Dict]:
        """The list a step works in: the graphed runner's step takes the
        caller's list over, so that each level's previous state (the
        caller's first states, on the first step) is released as soon as
        its step has replaced it; the eager step leaves the caller's list
        as it was."""
        return states if fixed is not None else list(states)

    def coarse_step(states: List[Dict], t: int) -> List[Dict]:
        states = own(states)
        t = int(t)

        def visit(lvl: int, k: int, iface):
            """Sub-step k of level `lvl` (t_sub = (t << lvl) + k), then its
            child's two sub-steps."""
            patch = patches[lvl]
            child = patches[lvl + 1] if lvl + 1 < n_levels else None
            old_sl = None
            if child is not None and use_temporal:
                old_sl = states[lvl].get("_ifsl")
                if old_sl is None:
                    # an unseeded call: the old slabs before the launch
                    # (a K5 parent overwrites f)
                    old_sl = endpoint_slabs(lvl, states[lvl])
            # the pre-step state has no consumer after the launch
            states[lvl] = level_step(states[lvl], lvl, *sub_step(t, lvl, k), iface)
            if child is None:
                return
            new_sl = endpoint_slabs(lvl, states[lvl])
            # the child's planes in its storage type: bf16 g, or float32 f
            c_dtype = f_dtype(states[lvl + 1])
            planes = ghost_planes_of(plans[lvl + 1], child, patch, old_sl, new_sl,
                                     use_temporal, c_dtype)
            if use_temporal:
                # the planes have read the old slabs: the new ones are carried
                states[lvl]["_ifsl"] = (new_sl if fixed is None
                                        else fixed.carry(old_sl, new_sl))
            if_a, if_b = cut_planes(lvl + 1, planes)
            if fuse_last and lvl + 1 == last:
                (ua, sa), (ub, sb) = (sub_step(t, last, 2 * k),
                                      sub_step(t, last, 2 * k + 1))
                fused(states, last, (ua, ub), (sa, sb), if_a, if_b)
                return
            visit(lvl + 1, 2 * k, if_a)
            visit(lvl + 1, 2 * k + 1, if_b)

        visit(0, 0, None)
        # visit refers to itself; clearing it breaks that cycle, which would
        # otherwise keep this step's states alive until the garbage
        # collector runs (up to a level's whole state per step)
        del visit
        if record is not None:
            record.advance(1)
        return list(states)

    def seed_slabs(states: List[Dict]) -> List[Dict]:
        """The states with "_ifsl", the endpoint slabs of each parent level,
        where it is missing (reference: solver_dense.py:573-590): the batch
        runner and `runner.solve_case` run it on their first states."""
        states = list(states)
        if use_temporal:
            for lvl in range(n_levels - 1):
                if "_ifsl" not in states[lvl]:
                    states[lvl] = {**states[lvl],
                                   "_ifsl": endpoint_slabs(lvl, states[lvl])}
        return states

    pair_step = None
    if fuse_last and n_levels == 1:
        def pair_step(states: List[Dict], t: int) -> List[Dict]:
            """Coarse steps t and t + 1 of a single-level case as one K3
            (inlet velocity and noise seed of each step its own) + K2."""
            states = own(states)
            t = int(t)
            if record is not None:
                fused(states, 0, (record.ref(0), record.ref(1)), (None, None),
                      None, None)
                record.advance(2)
                return list(states)
            fused(states, 0,
                  (ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps),
                   ramp_velocity(t + 1, cfg.u_lattice, cfg.ramp_steps)),
                  (t % 1000000, (t + 1) % 1000000), None, None)
            return states

    coarse_step.seed_slabs = seed_slabs
    coarse_step.pair_step = pair_step
    coarse_step.fused2 = fuse_last
    return coarse_step


def ghost_slabs(plan: Dict, state: Dict) -> List[Dict]:
    """A parent state's endpoint slabs for its child's planes: one launch of
    the extraction kernel on the card (`ghost_planes.extract_slabs`, the
    slabs views of one buffer), the plain `extract_endpoint_slabs` on the
    CPU."""
    if state["f"].is_cuda:
        return ghost_planes.extract_slabs(plan, state)
    return extract_endpoint_slabs(plan, state)


def ghost_planes_of(plan: Dict, child: PatchLevel, parent: PatchLevel,
                    old_sl: Optional[List[Dict]], new_sl: List[Dict],
                    use_temporal: bool, dtype: torch.dtype) -> Dict[int, torch.Tensor]:
    """A child build: the child's planes of one parent step from the old and
    new endpoint slabs, in the child's storage type `dtype` (bf16 g planes
    on bf16 levels, float32 f otherwise): one launch of the planes kernel
    where the slabs lie on a card (`ghost_planes.planes`), the plain
    `interface_planes_pair_mm` on the CPU.  Counts the build as
    "planes.kernel" or "planes.plain" (`spans.COUNTS`) at this call, so a
    captured build counts once and its replays do not."""
    kw = dict(g_shifted=dtype == torch.bfloat16, out_dtype=dtype)
    if new_sl[0]["f"].is_cuda:
        count("planes.kernel")
        return ghost_planes.planes(plan, child, parent, old_sl, new_sl, use_temporal,
                                   **kw)
    count("planes.plain")
    return interface_planes_pair_mm(plan, child, parent, old_sl, new_sl, use_temporal,
                                    **kw)


class FixedBuffers:
    """The graphed runner's state buffers and its step record.  Every A -> B
    step writes into the partner of its input (`out_of`): the first step
    on a tensor the runner did not make (the caller's first states)
    allocates a fresh output and keeps no hold on its input, so the
    caller's tensor is freed once the caller's list lets it go; the first
    step on a buffer of the runner's own allocates its partner, and from
    then on every level's state moves between those two buffers (A/B) and
    a graph's addresses hold.  An in-place level's f (K5) has no partner.
    `carry` copies a parent's new endpoint slabs into its carried ones: one
    copy where both are one buffer (the extraction kernel's, "buf"), else
    one per field and group."""

    def __init__(self, record):
        self.record = record
        self.partner: Dict[int, torch.Tensor] = {}
        self.owned: Dict[int, torch.Tensor] = {}

    def out_of(self, t):
        """The buffer a step on `t` (a tensor, or a list of x slabs') writes."""
        if isinstance(t, list):
            return [self.out_of(x) for x in t]
        key = t.data_ptr()
        if key in self.partner:
            return self.partner[key]
        out = torch.empty_like(t)
        self.owned[out.data_ptr()] = out
        if key in self.owned:
            self.partner[key], self.partner[out.data_ptr()] = out, t
        return out

    @staticmethod
    def carry(old: List[Dict], new: List[Dict]) -> List[Dict]:
        bo, bn = old[0].get("buf"), new[0].get("buf")
        if bo is not None and bn is not None and bo.shape == bn.shape:
            bo.copy_(bn)
            return old
        for o, n in zip(old, new):
            for key in ("f", "rho", "vel"):
                o[key].copy_(n[key])
        return old


def _leaves(states: List[Dict]) -> List[torch.Tensor]:
    """The f, rho and vel tensors of `states` (every slab's under a mesh)."""
    out = []
    for st in states:
        for key in ("f", "rho", "vel"):
            v = st[key]
            out.extend(v if isinstance(v, list) else [v])
    return out


def make_batch_runner_dense(cfg: CaseConfig, params: DomainParams,
                            patches: List[PatchLevel], statics: List[Dict],
                            fuse2: bool = False, x_mesh=None, graphs: bool = True):
    """run(states, t0, n) -> states after coarse steps t0 .. t0+n-1, with no
    host sync inside a batch.  Unfused by default; with `fuse2` (K3 pairs,
    `make_coarse_step_dense`) a single-level case with a pair step runs
    pairs of coarse steps, an odd batch of n >= 3 taking one plain step
    first (the JAX runner's rule, open_ludwig_tpu/solver_dense.py:690-700).
    The states first get their carried endpoint slabs (`run.seed_slabs`,
    idempotent).  `run` takes over the list it is given, as the JAX
    runner's jit takes its states (`donate_argnums=(0,)`): each step
    replaces the list's entries, so the caller's list does not keep the
    batch's first states alive on the device, and that list is returned.
    A level run in place (K5) updates the f tensor of the states passed in.
    With `x_mesh` the states are per slab (`parallel.patch_shard.
    shard_states`) and every coarse step is unfused (`run.fused2` False).

    With `graphs` (the default) the batch is one program, the counterpart
    of the JAX runner's jit + lax.scan: each coarse step (each pair, on a
    single level) is the step of `make_coarse_step_dense(fixed=...)` on
    fixed buffers (`FixedBuffers`) and a step record (`solver.StepRecord`,
    set to t0 on the stream at each call), and on a card it is replayed
    from a CUDA graph per kind of step and state addresses (`graphs.
    GraphSet`: the first run of each eager, the second captured with host
    syncs forbidden); the CPU, which has no graphs, runs the same steps on
    the same buffers eagerly.  A mesh over more than one physical card
    keeps the eager loop (`run.graph_note` says why).  The results are
    bit-equal to `graphs=False`, the loop that launches every kernel from
    the host with the step's numbers by value.  A state passed in that is
    not the runner's last result is copied into the runner's buffers.
    `run.graph_set` holds the graphs (None without).  A graphed call is
    the span `run` with `run.take`, `run.record` and its units' spans
    (`spans`, `graphs.GraphSet.run`)."""
    coarse_step = make_coarse_step_dense(cfg, params, patches, statics,
                                         fuse2=fuse2, x_mesh=x_mesh)
    pair = coarse_step.pair_step
    cards = ({d for d in x_mesh.devices} if x_mesh is not None else set())
    note = None
    if graphs and len(cards) > 1:
        graphs = False
        note = (f"[Graph] eager loop: the x mesh spans {len(cards)} cards, and "
                "one graph per card has never run here (one card to test on)")

    def run_eager(states: List[Dict], t0: int, n: int) -> List[Dict]:
        t0, n = int(t0), int(n)
        states[:] = coarse_step.seed_slabs(states)
        if pair is not None and n >= 2:
            if n % 2:
                states[:] = coarse_step(states, t0)
                t0, n = t0 + 1, n - 1
            for i in range(n // 2):
                states[:] = pair(states, t0 + 2 * i)
            return states
        for t in range(t0, t0 + n):
            states[:] = coarse_step(states, t)
        return states

    if not graphs:
        run_eager.fused2 = coarse_step.fused2
        run_eager.seed_slabs = coarse_step.seed_slabs
        run_eager.graph_set = None
        run_eager.graph_note = note
        return run_eager

    from .graphs import GraphSet
    from .solver import StepRecord

    gset = GraphSet("dense")
    held = {}  # "fixed", "step", "last": the states the last call returned

    def setup(device) -> None:
        fixed = FixedBuffers(StepRecord(cfg.u_lattice, cfg.ramp_steps, device))
        held["fixed"] = fixed
        held["step"] = make_coarse_step_dense(cfg, params, patches, statics,
                                              fuse2=fuse2, x_mesh=x_mesh,
                                              fixed=fixed)

    def take(states: List[Dict]) -> List[Dict]:
        """The caller's states on the runner's buffers: where the caller
        passes other tensors than the last result's, they are copied in,
        and carried slabs that are missing are the copied states' own."""
        last = held.get("last")
        if last is None:
            return coarse_step.seed_slabs(states)
        for st, mine in zip(states, last):
            for a, b in zip(_leaves([st]), _leaves([mine])):
                if a.data_ptr() != b.data_ptr():
                    b.copy_(a)
        fresh = None
        for lvl, (st, mine) in enumerate(zip(states, last)):
            if "_ifsl" not in mine or st.get("_ifsl") is mine["_ifsl"]:
                continue
            sl = st.get("_ifsl")
            if sl is None:
                if fresh is None:
                    fresh = coarse_step.seed_slabs(
                        [{k: m[k] for k in ("f", "rho", "vel")} for m in last])
                sl = fresh[lvl]["_ifsl"]
            FixedBuffers.carry(mine["_ifsl"], sl)
        return [dict(m) for m in last]

    def unit(kind: str, states: List[Dict], device) -> List[Dict]:
        step = held["step"]
        key = (kind,) + tuple(t.data_ptr() for t in _leaves(states))
        fn = ((lambda: step(states, 0)) if kind == "step" else
              (lambda: step.pair_step(states, 0)))
        out = gset.run(key, fn, device, steps=1 if kind == "step" else 2)
        return [dict(st) for st in out]

    def run(states: List[Dict], t0: int, n: int) -> List[Dict]:
        with span("run"):
            t0, n = int(t0), int(n)
            dev = _leaves(states[:1])[0].device
            if "fixed" not in held:
                setup(dev)
            with span("run.take"):
                states[:] = take(states)
            with span("run.record"):
                held["fixed"].record.set(t0)
            kinds = ["step"] * n
            if pair is not None and n >= 2:
                kinds = ["step"] * (n % 2) + ["pair"] * (n // 2)
            for kind in kinds:
                states[:] = unit(kind, states, dev)
            held["last"] = list(states)
            return states

    run.fused2 = coarse_step.fused2
    run.seed_slabs = coarse_step.seed_slabs
    run.graph_set = gset
    run.graph_note = note
    return run


def hbm_report_patches(patches: List[PatchLevel], statics: List[Dict],
                       precision: str = "float32", device="cpu", x_mesh=None) -> str:
    """Per-level device-memory accounting (`memory.case_bytes`, which the
    card's rule reads): resident state (f + rho + vel) and static fields,
    the Bouzidi plan, the carried endpoint slabs (two sets while the
    child's planes are built), the ghost planes' plan and working set
    (`memory.plan_bytes`), and each level's second buffers: an A -> B
    level (K1, K4, K3 pairs) a second f/rho/vel, a K5 level a second
    rho/vel and its edge buffer (bounded, `memory.edge_bound_elems`).  The graphed runner
    holds every level's second buffers for the whole run (`FixedBuffers`),
    so they add up over the levels.  With `x_mesh`, per slab and device
    (`parallel.patch_shard.hbm_report_sharded`)."""
    if x_mesh is not None:
        from .parallel.patch_shard import hbm_report_sharded
        return hbm_report_sharded(patches, statics, precision, x_mesh)
    dev = torch.device(device)
    lines, total = _hbm_account(patches, statics, precision)
    if dev.type == "cuda":
        live = torch.cuda.memory_allocated(dev)
        cap = torch.cuda.get_device_properties(dev).total_memory
        lines.append(f"  device live: {live/1e9:.3f} GB allocated of "
                     f"{cap/1e9:.1f} GB (estimate/live = "
                     f"{total/max(live, 1):.2f})")
    return "\n".join(lines)


def hbm_total_patches(patches: List[PatchLevel], statics: List[Dict],
                      precision: str = "float32", device="cpu") -> int:
    """The estimated total of `hbm_report_patches` (one device), in bytes."""
    return _hbm_account(patches, statics, precision)[1]


def _hbm_account(patches: List[PatchLevel], statics: List[Dict], precision: str
                 ) -> Tuple[List[str], int]:
    """The report's lines up to its estimated total, and that total."""
    f_bytes = 2 if storage.f_dtype(precision) == torch.bfloat16 else 4
    lines = [f"Device memory (dense patches, {precision} f-storage):"]
    second = 0
    mms = [st["iface_mm"] for st in statics]
    extra = memory.plans_extra([st["bouzidi"] for st in statics], mms, f_bytes)
    for li, (p, st) in enumerate(zip(patches, statics)):
        n = p.n_cells
        child_mm = mms[li + 1] if li + 1 < len(mms) else None
        bz_b, slab_b, plane_b = memory.plan_bytes(st["bouzidi"], mms[li], child_mm,
                                                  f_bytes)
        resident, sec = memory.level_bytes(n, f_bytes, st["engine"])
        second += sec
        if st["engine"] == "inplace":
            step = (f"K5 in place: rho/vel {n * 16 / 1e6:.1f} MB + edge buffer "
                    f"<= {(sec - n * 16) / 1e6:.1f} MB, no second f")
        else:
            step = f"A->B second f/rho/vel {sec / 1e6:.1f} MB"
        lines.append(
            f"  level {p.level_id}: {n/1e6:7.2f}M cells | state + fields "
            f"{resident/1e6:8.1f} MB | bouzidi {bz_b/1e6:5.1f} MB | step {step}"
            + (f" | carried ghost-plane slabs {slab_b/1e6:.2f} MB (x2 while the "
               "child's planes are built; the pre-step state is not held)"
               if child_mm else "")
            + (f" | ghost planes (plan + working set) {plane_b/1e6:.1f} MB"
               if plane_b else ""))
    total = memory.case_bytes(patches, [st["engine"] for st in statics], precision,
                              extra)["device"]
    lines.append(f"  estimated total: {total/1e9:.3f} GB (incl. {second/1e6:.0f} MB "
                 "of second buffers, every level's: the graphed runner holds them; "
                 "matmul workspaces and the flow statistics' chunk)")
    return lines, total

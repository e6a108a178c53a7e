"""Time stepping of the blocks layout, and the ramp shared by the schedulers.

Port of `open_ludwig_tpu/solver.py` (`ramp_velocity`, `_parent_view`,
`make_coarse_step`, `make_batch_runner`).  The reference recursion
(reference: src/solver_control.jl:21-143) visits level l 2^(l-1) times per
coarse step with temporal weights 0.0 / 0.5 on the two sub-steps.  Here it
is a Python unroll that only enqueues work: no host sync inside a batch.
Each sub-step consumes {f, rho, vel} and produces new tensors; the "old"
parent state that the children's temporal interpolation reads is the
parent's pre-step binding, alive for one coarse step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import CaseConfig
from .ops.stream_collide import apply_bouzidi, stream_collide
from .scaling import DomainParams
from .spans import span


def ramp_velocity(t: int, u_target: float, ramp_steps: int) -> float:
    """Cosine start-up ramp (reference: main.jl:173-174), in float32 on the
    host exactly as the JAX package evaluates it on the device.  Computing
    it on the host keeps the step loop free of device round trips."""
    t_f = np.float32(t)
    if t_f <= ramp_steps:
        prog = np.float32(0.5) * (
            np.float32(1.0)
            - np.cos(np.float32(np.pi) * t_f / np.float32(max(ramp_steps, 1)))
        )
    else:
        prog = np.float32(1.0)
    return float(np.float32(u_target) * prog)


class StepRecord:
    """The step record on a device: the coarse-step counter `t` (int32,
    one entry) and the inlet-speed table `u` (float32), u[t] =
    `ramp_velocity(t)` for 0 <= t <= `last` = ramp_steps + 1, filled from
    that function so that it holds the same bits; past the ramp the speed
    is u[last].  A coarse step captured in a CUDA graph reads its speed and
    noise seeds from the record and advances `t` on the device, so one
    graph serves every step: sub-step k of the level `shift` levels below
    the coarsest, `dt` coarse steps past t, reads u[min(t + dt, last)] and
    the seed ((t + dt) << shift) + k) % 1000000, the `t_sub % 1000000` of
    the eager schedule (`ref`)."""

    def __init__(self, u_target: float, ramp_steps: int, device):
        self.last = max(int(ramp_steps), 0) + 1
        table = np.array([ramp_velocity(t, u_target, ramp_steps)
                          for t in range(self.last + 1)], dtype=np.float32)
        self.u = torch.as_tensor(table).to(device)
        self.t = torch.zeros(1, dtype=torch.int32, device=device)

    def set(self, t: int) -> None:
        """The counter at coarse step t (one fill, queued on the stream)."""
        self.t.fill_(int(t))

    def advance(self, n: int) -> None:
        self.t.add_(int(n))

    def ref(self, dt: int = 0, shift: int = 0, k: int = 0) -> "StepRef":
        return StepRef(self, int(dt), int(shift), int(k))


class StepRef:
    """One sub-step's entry in a `StepRecord`: what a kernel wrapper takes
    in place of (u_inlet, t_seed) to read both on the device."""

    __slots__ = ("record", "dt", "shift", "k")

    def __init__(self, record: StepRecord, dt: int, shift: int, k: int):
        self.record, self.dt, self.shift, self.k = record, dt, shift, k

    def host(self) -> Tuple[float, int]:
        """(u_inlet, t_seed) read from the record: a CPU record's values
        (on a CUDA record this would wait for the card)."""
        tc = int(self.record.t[0]) + self.dt
        return (float(self.record.u[min(tc, self.record.last)]),
                ((tc << self.shift) + self.k) % 1000000)

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(u_inlet, t_seed) as 0-d tensors on the record's device, computed
        there (the plain-torch step's form: nothing read back)."""
        r = self.record
        tc = r.t.long() + self.dt
        u = r.u.index_select(0, tc.clamp(max=r.last)).reshape(())
        return u, (((tc << self.shift) + self.k) % 1000000).reshape(())


def _parent_view(state: Dict, old: Dict) -> Dict:
    return {
        "f": state["f"].reshape(27, -1),
        "rho": state["rho"].reshape(-1),
        "vel": state["vel"].reshape(3, -1),
        "f_old": old["f"].reshape(27, -1),
        "rho_old": old["rho"].reshape(-1),
        "vel_old": old["vel"].reshape(3, -1),
    }


def make_coarse_step(cfg: CaseConfig, params: DomainParams, statics: List[Dict],
                     record: "StepRecord" = None):
    """Returns coarse_step(states, t) -> states advancing ALL levels by one
    coarse step (level l advances 2^(l-1) sub-steps).  With `record` the
    inlet speed and the seeds are 0-d tensors computed on the device from
    the step record (t is then the record's), which the step advances by
    one: the graphed runner's step."""
    n_levels = len(statics)
    use_temporal = cfg.temporal_interpolation

    def coarse_step(states: List[Dict], t: int) -> List[Dict]:
        states = list(states)
        t = int(t)
        if record is not None:
            u_curr = record.ref().tensors()[0]
        else:
            # one fill launch, where a host scalar copied to the card would
            # wait for the queued work
            u_curr = torch.full((), ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps),
                                dtype=torch.float32, device=states[0]["f"].device)

        def step_level(lvl: int, k: int, temporal_weight: float, parent_view):
            st = states[lvl]
            static = statics[lvl]
            seed = (record.ref(0, lvl, k).tensors()[1] if record is not None
                    else ((t << lvl) + k) % 1000000)
            f_new, rho_new, vel_new = stream_collide(
                st["f"],
                st["vel"],
                u_curr,
                seed,
                static,
                tau=float(params.tau_levels[lvl]),
                c_wale=cfg.c_wale,
                nu_sgs_background=cfg.nu_sgs_background,
                inlet_turbulence=cfg.inlet_turbulence_intensity,
                wall_model=cfg.wall_model_enabled,
                sponge_blend=cfg.sponge_blend_distributions,
                use_temporal=use_temporal,
                temporal_weight=temporal_weight,
                parent=parent_view,
            )
            if static["bouzidi"] is not None:
                f_new = apply_bouzidi(f_new, static["bouzidi"])
            states[lvl] = {"f": f_new, "rho": rho_new, "vel": vel_new}

        def visit(lvl: int, k: int, temporal_weight: float, parent_view):
            """Sub-step k of level `lvl` (t_sub = (t << lvl) + k), then its
            children's."""
            has_children = lvl + 1 < n_levels
            old = states[lvl] if (has_children and use_temporal) else None
            step_level(lvl, k, temporal_weight, parent_view)
            if has_children:
                pv = _parent_view(states[lvl], old if old is not None else states[lvl])
                visit(lvl + 1, 2 * k, 0.0, pv)
                visit(lvl + 1, 2 * k + 1, 0.5, pv)

        visit(0, 0, 0.0, None)
        # visit refers to itself; clearing it breaks that cycle, which would
        # otherwise keep this step's states alive until the garbage
        # collector runs (every level's state, per coarse step)
        del visit
        if record is not None:
            record.advance(1)
        return states

    return coarse_step


def make_batch_runner(cfg: CaseConfig, params: DomainParams, statics: List[Dict],
                      graphs: bool = True):
    """run(states, t0, n) -> states after coarse steps t0 .. t0+n-1, with
    no host sync inside a batch (reference: gpu.async_depth batching,
    main.jl:166-180).  With `graphs` (the default) the batch is one
    program, as the JAX package jits its lax.scan
    (open_ludwig_tpu/solver.py:102-113): the step reads the step record
    (set to t0 at each call) and its new states are copied into fixed
    state buffers at its end (the block step makes new tensors), so on a
    card each coarse step is one replay of a CUDA graph (`graphs.GraphSet`;
    its first run eager, the second captured with host syncs forbidden),
    and on the CPU the same step runs eagerly.  The fixed buffers are the
    first call's states, taken over; a later call given other tensors
    than the last result has them copied in.  Bit-equal to `graphs=False`,
    the loop that launches every operation from the host.  A graphed call is
    the span `run` with `run.take`, `run.record` and its units' spans
    (`spans`, `graphs.GraphSet.run`)."""
    coarse_step = make_coarse_step(cfg, params, statics)
    if not graphs:
        def run_eager(states: List[Dict], t0: int, n: int) -> List[Dict]:
            for t in range(int(t0), int(t0) + int(n)):
                states = coarse_step(states, t)
            return states

        run_eager.graph_set = None
        return run_eager

    from .graphs import GraphSet

    gset = GraphSet("blocks")
    held = {}  # "record", "step", "fixed": the state buffers

    def run(states: List[Dict], t0: int, n: int) -> List[Dict]:
        with span("run"):
            dev = states[0]["f"].device
            if "fixed" not in held:
                held["record"] = StepRecord(cfg.u_lattice, cfg.ramp_steps, dev)
                held["step"] = make_coarse_step(cfg, params, statics, held["record"])
                held["fixed"] = [{k: st[k] for k in ("f", "rho", "vel")}
                                 for st in states]
            fixed = held["fixed"]
            with span("run.take"):
                for st, mine in zip(states, fixed):
                    for k in ("f", "rho", "vel"):
                        if st[k].data_ptr() != mine[k].data_ptr():
                            mine[k].copy_(st[k])

            def unit():
                new = held["step"](fixed, 0)
                for st, mine in zip(new, fixed):
                    for k in ("f", "rho", "vel"):
                        mine[k].copy_(st[k])
                return fixed

            with span("run.record"):
                held["record"].set(t0)
            for _ in range(int(n)):
                gset.run("step", unit, dev)
            return [dict(st) for st in fixed]

    run.graph_set = gset
    return run

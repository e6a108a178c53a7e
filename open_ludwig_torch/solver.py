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

from typing import Dict, List

import numpy as np
import torch

from .config import CaseConfig
from .ops.stream_collide import apply_bouzidi, stream_collide
from .scaling import DomainParams


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


def _parent_view(state: Dict, old: Dict) -> Dict:
    return {
        "f": state["f"].reshape(27, -1),
        "rho": state["rho"].reshape(-1),
        "vel": state["vel"].reshape(3, -1),
        "f_old": old["f"].reshape(27, -1),
        "rho_old": old["rho"].reshape(-1),
        "vel_old": old["vel"].reshape(3, -1),
    }


def make_coarse_step(cfg: CaseConfig, params: DomainParams, statics: List[Dict]):
    """Returns coarse_step(states, t) -> states advancing ALL levels by one
    coarse step (level l advances 2^(l-1) sub-steps)."""
    n_levels = len(statics)
    use_temporal = cfg.temporal_interpolation

    def coarse_step(states: List[Dict], t: int) -> List[Dict]:
        states = list(states)
        t = int(t)
        # one fill launch, where a host scalar copied to the card would wait
        # for the queued work
        u_curr = torch.full((), ramp_velocity(t, cfg.u_lattice, cfg.ramp_steps),
                            dtype=torch.float32, device=states[0]["f"].device)

        def step_level(lvl: int, t_sub: int, temporal_weight: float, parent_view):
            st = states[lvl]
            static = statics[lvl]
            f_new, rho_new, vel_new = stream_collide(
                st["f"],
                st["vel"],
                u_curr,
                t_sub % 1000000,
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

        def visit(lvl: int, t_sub: int, temporal_weight: float, parent_view):
            has_children = lvl + 1 < n_levels
            old = states[lvl] if (has_children and use_temporal) else None
            step_level(lvl, t_sub, temporal_weight, parent_view)
            if has_children:
                pv = _parent_view(states[lvl], old if old is not None else states[lvl])
                visit(lvl + 1, 2 * t_sub, 0.0, pv)
                visit(lvl + 1, 2 * t_sub + 1, 0.5, pv)

        visit(0, t, 0.0, None)
        # visit refers to itself; clearing it breaks that cycle, which would
        # otherwise keep this step's states alive until the garbage
        # collector runs (every level's state, per coarse step)
        del visit
        return states

    return coarse_step


def make_batch_runner(cfg: CaseConfig, params: DomainParams, statics: List[Dict]):
    """run(states, t0, n) -> states after coarse steps t0 .. t0+n-1: a
    plain loop that only enqueues work (the JAX package's lax.scan over
    the diagnostics interval; reference: gpu.async_depth batching,
    main.jl:166-180)."""
    coarse_step = make_coarse_step(cfg, params, statics)

    def run(states: List[Dict], t0: int, n: int) -> List[Dict]:
        for t in range(int(t0), int(t0) + int(n)):
            states = coarse_step(states, t)
        return states

    return run

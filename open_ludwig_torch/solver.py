"""Time-stepping helpers shared by the schedulers."""

from __future__ import annotations

import numpy as np


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

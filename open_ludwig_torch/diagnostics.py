"""Flow statistics and stability checks (port of
`open_ludwig_tpu/diagnostics.py`: FlowStats, compute_flow_stats,
check_stability; reference: src/diagnostics.jl:56-125)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch


@dataclass
class FlowStats:
    n_fluid: int
    rho_mean: float
    rho_min: float
    rho_max: float
    v_max: float
    kinetic_energy: float


def compute_flow_stats(state: Dict, obstacle: torch.Tensor) -> FlowStats:
    """Masked reductions over the fluid cells of one level (one host sync)."""
    rho, vel = state["rho"], state["vel"]
    fluid = ~obstacle
    n_fluid = fluid.sum()
    big = torch.tensor(1e30, dtype=torch.float32, device=rho.device)
    zero = torch.zeros((), dtype=torch.float32, device=rho.device)
    rho_min = torch.where(fluid, rho, big).min()
    rho_max = torch.where(fluid, rho, -big).max()
    rho_mean = torch.where(fluid, rho, zero).sum() / n_fluid.clamp(min=1)
    v2 = (vel * vel).sum(dim=0)
    v_max = torch.sqrt(torch.where(fluid, v2, zero).max())
    ke = 0.5 * torch.where(fluid, rho * v2, zero).sum()
    vals = torch.stack([
        n_fluid.float(), rho_mean, rho_min, rho_max, v_max, ke
    ]).cpu().tolist()
    return FlowStats(int(vals[0]), *[float(v) for v in vals[1:]])


def check_stability(stats: FlowStats, step: int) -> List[str]:
    warnings = []
    if stats.v_max > 0.3:
        warnings.append(f"High velocity: {stats.v_max:.4f} (Ma > 0.5)")
    if stats.rho_min < 0.5:
        warnings.append(f"Low density: {stats.rho_min:.4f}")
    if stats.rho_max > 1.5:
        warnings.append(f"High density: {stats.rho_max:.4f}")
    return warnings

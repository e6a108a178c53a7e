"""The numbers that decide `correct`, each held to its limit.

  - `start_gap`: after the first `check_steps` coarse steps from the warm
    start (set-up's first call of the runner, the same seeded state handed
    to both sides), the widest gap between the program's levels and the
    reference's: the largest of max |f - f_ref| (f decoded to float32),
    max |rho - rho_ref| and max |u - u_ref| over every cell of every level;
  - `end_gap`: the same after `check_steps` more coarse steps of the
    runner once the window has closed, the reference starting from the
    program's state at the window's close (the reference cannot follow a
    window of thousands of steps, and the flow is chaotic: it follows the
    program step by step from the program's own state, and `start_gap`
    checks the start on its own);
  - `force_gap` (cells whose traffic evaluates forces): the widest gap
    between the program's stress-mapped Cd, Cl, Cs on its state after
    those steps and the reference's on its own;
  - `stats_gap` (cells whose traffic takes flow statistics): the widest
    relative gap between the program's flow statistics of level 1 and the
    reference's, over rho_mean, rho_min, rho_max, v_max and the kinetic
    energy (the fluid cells' count must be equal).

Each configuration's `limits.json` holds the limits and the readings they
were set from.  A number above its limit, or not finite, is not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .reference.olt.ops.storage import decode_f

_CHUNK = 1 << 22  # cells of the x-plane runs a level is compared in


def state_gap(prog: List[Dict], ref: List[Dict], device=None) -> float:
    """The widest gap between two sets of levels, `prog` (the program's
    states as copied to the host) against `ref`, f decoded, compared on
    `device` (default: ref's) in runs of x planes."""
    gap = 0.0
    for p, r in zip(prog, ref):
        dev = device or r["f"].device
        X = r["f"].shape[1]
        plane = max(r["f"].shape[2] * r["f"].shape[3], 1)
        run = max(1, _CHUNK // plane)
        for a in range(0, X, run):
            b = min(X, a + run)
            parts = [
                (decode_f(p["f"][:, a:b].to(dev)) - decode_f(r["f"][:, a:b].to(dev))).abs().max(),
                (p["rho"][a:b].to(dev) - r["rho"][a:b].to(dev)).abs().max(),
                (p["vel"][:, a:b].to(dev) - r["vel"][:, a:b].to(dev)).abs().max(),
            ]
            m = torch.stack(parts).max().item()
            if not math.isfinite(m):
                return math.inf
            gap = max(gap, m)
    return gap


def force_gap(prog, ref) -> float:
    """The widest gap of Cd, Cl and Cs between two force results."""
    return max(abs(float(getattr(prog, c)) - float(getattr(ref, c)))
               for c in ("Cd", "Cl", "Cs"))


STATS = ("rho_mean", "rho_min", "rho_max", "v_max", "kinetic_energy")


def stats_gap(prog, ref) -> float:
    """The widest relative gap of the flow statistics; inf where the
    fluid cells' counts differ."""
    if int(prog.n_fluid) != int(ref.n_fluid):
        return math.inf
    gaps = [abs(float(getattr(prog, s)) - float(getattr(ref, s)))
            / max(abs(float(getattr(ref, s))), 1e-30) for s in STATS]
    return max(gaps)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit, with whether it holds.  A number
    computed without a limit, or a limit without its number, fails."""
    out = {}
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name), limits.get(name)
        ok = (v is not None and lim is not None and math.isfinite(v) and v <= lim)
        out[name] = {"value": v, "limit": lim, "ok": ok}
    return out


def host_copy(states: List[Dict]) -> List[Dict]:
    """f, rho and vel of each level copied to the host."""
    return [{k: st[k].to("cpu", copy=True) for k in ("f", "rho", "vel")}
            for st in states]


def to_device(states: List[Dict], device) -> List[Dict]:
    return [{k: st[k].to(device) for k in ("f", "rho", "vel")} for st in states]


def limits_for(limits: Dict, wanted: List[str]) -> Dict[str, Optional[float]]:
    """The limits of the numbers a cell computes (None where missing)."""
    table = limits.get("limits", {})
    return {name: table.get(name) for name in wanted}

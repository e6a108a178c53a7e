"""The warm start every traffic mix begins from, made from the seed.

Each fluid cell starts at the free-stream equilibrium, rho = 1 and u =
(U, 0, 0) with U the case's lattice inlet speed, perturbed cell by cell:
rho by a uniform draw in +-`perturb_rho`, each velocity component by a
uniform draw in +-`perturb_u` U.  Obstacle cells hold the port's rest
state (f = w, rho = 1, u = 0).  From rest the wall model's branch runs
idle; from here every near-wall fluid cell takes it from the first step.

The draws come from one `torch.Generator` on the state's device, seeded
with the seed, level after level, in a fixed order over the whole of each
level (the obstacle only masks them), so a level's draws do not depend on
its obstacle and the same seed gives the same state on both sides.  f is
the second-order D3Q27 equilibrium in float32, stored as the level's
storage type: float32 f, or bf16 g = f - w.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .reference.olt import lattice as lat

_CHUNK = 1 << 22  # cells of the x-plane runs f is computed in


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any int; reduced mod 2^63)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def level_state(obstacle: torch.Tensor, u0: float, store_bf16: bool,
                gen: torch.Generator, perturb_rho: float, perturb_u: float,
                out: Optional[Dict] = None) -> Dict:
    """One level's warm state {f, rho, vel} on the obstacle's device, drawing
    rho's perturbation, then u's (3, X, Y, Z), from `gen`, written into the
    tensors of `out` where given (the same values).  f is computed in runs
    of x planes, so the only large tensors are the state's own."""
    dev = obstacle.device
    shape = tuple(obstacle.shape)
    f_type = torch.bfloat16 if store_bf16 else torch.float32
    if out is None:
        out = {"f": torch.empty((27,) + shape, dtype=f_type, device=dev),
               "rho": torch.empty(shape, dtype=torch.float32, device=dev),
               "vel": torch.empty((3,) + shape, dtype=torch.float32, device=dev)}
    f, rho, vel = out["f"], out["rho"], out["vel"]
    if f.dtype != f_type or tuple(rho.shape) != shape:
        raise ValueError(f"warm start into f {f.dtype}, rho {tuple(rho.shape)}: the level "
                         f"stores {f_type} over {shape}")
    torch.rand(shape, generator=gen, device=dev, dtype=torch.float32, out=rho)
    rho.mul_(2.0).sub_(1.0).mul_(perturb_rho).add_(1.0).masked_fill_(obstacle, 1.0)
    torch.rand((3,) + shape, generator=gen, device=dev, dtype=torch.float32, out=vel)
    vel.mul_(2.0).sub_(1.0).mul_(perturb_u * u0)
    vel[0] += u0
    vel.masked_fill_(obstacle.unsqueeze(0), 0.0)
    plane = max(shape[1] * shape[2], 1)
    run = max(1, _CHUNK // plane)
    for a in range(0, shape[0], run):
        r, v = rho[a:a + run], vel[:, a:a + run]
        usq = (v * v).sum(0)
        for k in range(27):
            cu = float(lat.C_X[k]) * v[0] + float(lat.C_Y[k]) * v[1] + float(lat.C_Z[k]) * v[2]
            w = float(lat.W[k])
            fk = w * r * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
            f[k, a:a + run] = (fk - w) if store_bf16 else fk
    return {"f": f, "rho": rho, "vel": vel}


def warm_states(obstacles: Sequence[torch.Tensor], u0: float, store_bf16: bool,
                seed: int, perturb_rho: float, perturb_u: float,
                out: Optional[Sequence[Dict]] = None) -> List[Dict]:
    """Every level's warm state, from one generator seeded with `seed`,
    written into the levels' tensors of `out` where given."""
    gen = generator(seed, obstacles[0].device)
    return [level_state(ob, u0, store_bf16, gen, perturb_rho, perturb_u,
                        None if out is None else out[i])
            for i, ob in enumerate(obstacles)]

"""D3Q27 lattice tables: numpy constants and torch tensor copies.

The port's own copy of the tables of `open_ludwig_tpu/lattice.py:22-90`
(reference: src/lattice.jl:13-71), with the same direction order
k = (cx+1) + 3(cy+1) + 9(cz+1), cx fastest; `tests/test_torch_host_modules.py`
holds them equal.  Weights by |c|^2: 8/27 (0), 2/27 (1), 1/54 (2),
1/216 (3); cs^2 = 1/3.  `tables` builds per-device float32 tensor copies
on demand; `equilibrium_np` is the reference's float64 equilibrium (:134).
The blocks layout's `BLOCK_EDGE`, `BLOCK_CELLS` and `OFF` are :129-131.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np
import torch

Q = 27
CS2 = 1.0 / 3.0


def _build():
    cx = np.zeros(Q, np.int32)
    cy = np.zeros(Q, np.int32)
    cz = np.zeros(Q, np.int32)
    w = np.zeros(Q, np.float64)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                k = (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)
                cx[k], cy[k], cz[k] = dx, dy, dz
                d2 = dx * dx + dy * dy + dz * dz
                w[k] = (8 / 27, 2 / 27, 1 / 54, 1 / 216)[d2]
    opp = np.zeros(Q, np.int32)
    mirror_y = np.zeros(Q, np.int32)
    mirror_z = np.zeros(Q, np.int32)
    for i in range(Q):
        opp[i] = (-cx[i] + 1) + 3 * (-cy[i] + 1) + 9 * (-cz[i] + 1)
        mirror_y[i] = (cx[i] + 1) + 3 * (-cy[i] + 1) + 9 * (cz[i] + 1)
        mirror_z[i] = (cx[i] + 1) + 3 * (cy[i] + 1) + 9 * (-cz[i] + 1)
    return cx, cy, cz, w, opp, mirror_y, mirror_z


C_X, C_Y, C_Z, W64, OPP, MIRROR_Y, MIRROR_Z = _build()
W = W64.astype(np.float32)

# (3, 27) float32 matrix of lattice velocities, for c·u style contractions.
C = np.stack([C_X, C_Y, C_Z]).astype(np.float32)

# Pi = PI_MAT @ f_neq, PI_MAT (6, 27); components xx, yy, zz, xy, yz, zx.
PI_MAT = np.stack(
    [C_X * C_X, C_Y * C_Y, C_Z * C_Z, C_X * C_Y, C_Y * C_Z, C_Z * C_X]
).astype(np.float32)

# Regularized reconstruction f_neq_reg = REG_MAT @ Pi6, REG_MAT (27, 6):
# w_k * 4.5 * (Pi : Q_k), Q_k = c_k c_k - cs^2 I, off-diagonals doubled
# (reference: src/physics_kernels.jl:339-346).
REG_MAT = (
    4.5
    * W64[:, None]
    * np.stack(
        [
            C_X * C_X - CS2,
            C_Y * C_Y - CS2,
            C_Z * C_Z - CS2,
            2.0 * C_X * C_Y,
            2.0 * C_Y * C_Z,
            2.0 * C_Z * C_X,
        ],
        axis=1,
    )
).astype(np.float32)

# Flat-cell roll offset inside an 8^3 block for pull streaming (the blocks
# layout, `open_ludwig_tpu/lattice.py:126-131`).  Local flat index
# = z*64 + y*8 + x; source cell = (x-cx, y-cy, z-cz), so
# streamed[k][flat] = f[k][flat - OFF[k]] = roll(f[k], OFF[k]).
BLOCK_EDGE = 8
BLOCK_CELLS = BLOCK_EDGE**3
OFF = (C_Z * BLOCK_EDGE * BLOCK_EDGE + C_Y * BLOCK_EDGE + C_X).astype(np.int32)


@lru_cache(maxsize=None)
def tables(device: str) -> Dict[str, torch.Tensor]:
    """Device copies: W (27,) and CX (27,) float32, OPP (27,) int64."""
    dev = torch.device(device)
    return {
        "W": torch.as_tensor(W, dtype=torch.float32, device=dev),
        "CX": torch.as_tensor(C_X, dtype=torch.float32, device=dev),
        "OPP": torch.as_tensor(OPP, dtype=torch.long, device=dev),
    }


def w_view(device, ndim: int, k_axis: int = 0) -> torch.Tensor:
    """Lattice weights shaped to broadcast along `k_axis` of an ndim array."""
    shape = [1] * ndim
    shape[k_axis] = Q
    return tables(str(device))["W"].reshape(shape)


def equilibrium_np(rho, ux, uy, uz):
    """Second-order Maxwell-Boltzmann equilibrium, numpy reference (a copy
    of `open_ludwig_tpu/lattice.py:134`; reference:
    src/physics_utils.jl:34-39).

    Shapes: rho/ux/uy/uz broadcastable; returns (..., 27) float64.
    """
    rho = np.asarray(rho, np.float64)[..., None]
    cu = (
        np.asarray(ux, np.float64)[..., None] * C_X
        + np.asarray(uy, np.float64)[..., None] * C_Y
        + np.asarray(uz, np.float64)[..., None] * C_Z
    )
    usq = (
        np.asarray(ux, np.float64) ** 2
        + np.asarray(uy, np.float64) ** 2
        + np.asarray(uz, np.float64) ** 2
    )[..., None]
    return rho * W64 * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)

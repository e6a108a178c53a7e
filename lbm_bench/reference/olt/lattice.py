# Frozen copy of open_ludwig_torch/lattice.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""D3Q27 lattice tables: numpy constants and torch tensor copies.

The port's own copy of the tables of `open_ludwig_tpu/lattice.py:22-90`
(reference: src/lattice.jl:13-71), with the same direction order
k = (cx+1) + 3(cy+1) + 9(cz+1), cx fastest; `tests/test_torch_host_modules.py`
holds them equal.  Weights by |c|^2: 8/27 (0), 2/27 (1), 1/54 (2),
1/216 (3); cs^2 = 1/3.  `tables` builds per-device float32 tensor copies
on demand.  The blocks layout's `BLOCK_EDGE` is :129.
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

BLOCK_EDGE = 8  # the blocks layout's block edge (`open_ludwig_tpu/lattice.py:129`)


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

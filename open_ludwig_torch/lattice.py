"""D3Q27 lattice tables as torch tensors.

The numpy tables of `open_ludwig_tpu.lattice` are the single source (same
direction order k = (cx+1) + 3(cy+1) + 9(cz+1)); this module re-exports
them and builds per-device float32 tensor copies on demand.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch

from open_ludwig_tpu.lattice import (  # noqa: F401  (re-exported)
    C,
    C_X,
    C_Y,
    C_Z,
    MIRROR_Y,
    MIRROR_Z,
    OPP,
    PI_MAT,
    Q,
    REG_MAT,
    W,
)


@lru_cache(maxsize=None)
def tables(device: str) -> Dict[str, torch.Tensor]:
    """float32 device copies: W (27,) and CX (27,)."""
    dev = torch.device(device)
    return {
        "W": torch.as_tensor(W, dtype=torch.float32, device=dev),
        "CX": torch.as_tensor(C_X, dtype=torch.float32, device=dev),
    }


def w_view(device, ndim: int, k_axis: int = 0) -> torch.Tensor:
    """Lattice weights shaped to broadcast along `k_axis` of an ndim array."""
    shape = [1] * ndim
    shape[k_axis] = Q
    return tables(str(device))["W"].reshape(shape)

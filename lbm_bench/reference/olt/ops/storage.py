# Frozen copy of open_ludwig_torch/ops/storage.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""f-storage codec: float32 f, or bfloat16 g = f - w.

Port of `open_ludwig_tpu/ops/storage.py`.  The shifted form g_k = f_k - w_k
spends the bf16 mantissa on the O(u) deviation (Lehmann et al. 2022); at
rest g = 0 exactly.  All arithmetic stays float32; only the resident
state is bf16.  Casts round to nearest even, like XLA's convert, so the
codec is bit-equal to the JAX one.
"""

from __future__ import annotations

import torch

from .. import lattice as lat

STORE_F32 = "float32"
STORE_BF16 = "bfloat16"

_ALIASES = {
    "float32": STORE_F32,
    "f32": STORE_F32,
    "single": STORE_F32,
    "bfloat16": STORE_BF16,
    "bf16": STORE_BF16,
}


def normalize_precision(precision: str) -> str:
    try:
        return _ALIASES[str(precision).lower()]
    except KeyError:
        raise ValueError(
            f"unsupported precision {precision!r}; use float32 or bfloat16"
        ) from None


def f_dtype(precision: str) -> torch.dtype:
    if normalize_precision(precision) == STORE_BF16:
        return torch.bfloat16
    return torch.float32


def encode_f(f: torch.Tensor, precision: str) -> torch.Tensor:
    """float32 f (27, ...) -> stored representation."""
    if normalize_precision(precision) == STORE_BF16:
        return (f - lat.w_view(f.device, f.ndim)).to(torch.bfloat16)
    return f


def decode_f(g: torch.Tensor, k_axis: int = 0) -> torch.Tensor:
    """Stored representation -> float32 f; `k_axis` is the 27 axis."""
    if g.dtype == torch.bfloat16:
        return g.float() + lat.w_view(g.device, g.ndim, k_axis)
    return g

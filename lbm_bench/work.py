"""The work a coarse step does, the card's peaks, and the launch count.

Frozen copies, from open_ludwig_torch at commit 8d8a57a:
  - `CARD_PEAKS`, `CELL_OPS` and `step_work` from `checks.py` (CARD_PEAKS,
    CELL_OPS, step_work): bytes of each input read once and each output
    written once per stream-collide sub-step, float32 operations counted
    from the cell body's source;
  - `batch_launches` from `bench.py` (batch_launches), unfused only: the
    kernel launches n coarse steps of the batch runner execute;
  - `warm_up` from `tools/profile_slice.py` (warm_up, MAX_WARMUP): calls
    until a graphed call launches nothing from the host.
They read the program's levels (shapes, faces) and its launch counters
(`ops.cuda_step.LAUNCHES`), never its arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Published peaks by `torch.cuda.get_device_name` (NVIDIA's H100 SXM data
# sheet: HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s,
# both at the 700 W power limit).
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                        "f32_ops_per_s": 67e12}}
# float32 operations of one fluid cell's sub-step (csrc/lbm_cell.cuh of the
# port at the commit above), counted from the source without the wall
# model's branch: moments ~131, sponge ~21, velocity gradient 18, WALE
# ~106, regularized BGK + Guo ~47, reconstruction ~108, rounded up.
CELL_OPS = 450
BC_INTERFACE = 4  # core/patch.py's face code of an interface face
MAX_WARMUP = 8  # warm-up calls allowed before a graphed runner must be all replays

_KERNEL = {"k1": "stream_collide", "flat": "stream_collide_flat",
           "inplace": "stream_collide_inplace"}


def step_work(interior: Sequence[int], face_bc: Sequence[int], store_bf16: bool,
              wall_model: bool, sub_steps: int = 1) -> Tuple[int, int]:
    """(bytes, float32 operations) of `sub_steps` fused stream-collide
    sub-steps of a level of `interior` cells with faces `face_bc` (one
    unfused sub-step: `sub_steps` 1): f, vel, obstacle,
    sponge and (with the wall model) the wall distance read once, f, rho
    and vel written once, and each sub-step's interface ghost planes,
    pre-shifted (27, A, B) in the storage type, read once."""
    fb = 2 if store_bf16 else 4
    n_cells = int(interior[0]) * int(interior[1]) * int(interior[2])
    per_cell = 27 * fb + 12 + 1 + 4 + (4 if wall_model else 0) + 27 * fb + 4 + 12
    planes = 0
    for fc in range(6):
        if face_bc[fc] == BC_INTERFACE:
            a, b = (int(interior[t]) for t in range(3) if t != fc // 2)
            planes += 27 * a * b * fb
    return (n_cells * per_cell + sub_steps * planes,
            sub_steps * CELL_OPS * n_cells)


def least_seconds(nbytes: float, ops: float, device_name: str):
    """The least time the card `device_name` could take for `nbytes` and
    `ops` float32 operations, or None where its peaks are not recorded."""
    peak = CARD_PEAKS.get(device_name)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_per_s"], ops / peak["f32_ops_per_s"])


def batch_launches(engines: List[str], bouzidi: List[bool], n: int) -> Dict[str, int]:
    """Kernel launches that n coarse steps of the unfused batch runner
    execute: level l runs n 2^l sub-steps on its engine's kernel, K2 after
    each on a Bouzidi level."""
    want: Dict[str, int] = {}
    for lvl, (eng, bz) in enumerate(zip(engines, bouzidi)):
        sub = n * 2 ** lvl
        want[_KERNEL[eng]] = want.get(_KERNEL[eng], 0) + sub
        if bz:
            want["bouzidi"] = want.get("bouzidi", 0) + sub
    return want


def warm_up(call, launches) -> int:
    """`call()` until it launches nothing from the host (`launches()`, the
    program's count of kernel launches issued), at most MAX_WARMUP times:
    a graphed runner runs each (kind, addresses) key eagerly at its first
    use and captures it at its second.  Returns the calls made."""
    for i in range(MAX_WARMUP):
        issued = launches()
        call()
        if launches() == issued:
            return i + 1
    raise RuntimeError(f"warm-up: the runner still launched from the host after "
                       f"{MAX_WARMUP} calls")


def steps_least_seconds(levels: Sequence[Dict], store_bf16: bool, wall_model: bool,
                        coarse_steps: int, device_name: str):
    """The least time of `coarse_steps` coarse steps' stream-collide work:
    each level's `step_work` for one sub-step times its sub-steps a coarse
    step (`levels`: interior, face_bc, sub_steps), at the card's peaks."""
    nbytes = ops = 0
    for lv in levels:
        b, o = step_work(lv["interior"], lv["face_bc"], store_bf16, wall_model, 1)
        nbytes += b * lv["sub_steps"] * coarse_steps
        ops += o * lv["sub_steps"] * coarse_steps
    return least_seconds(nbytes, ops, device_name)

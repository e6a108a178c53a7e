"""The region layout of K5, the in-place stream-collide step
(csrc/stream_collide_inplace.cu mirrors this file; ops/cuda_step.py sizes
the edge buffer and launches with it).

An (X, Y, Z) level is cut into regions of `ty` rows along y, all of z, and
a run of `xr` planes along x: one block of `THREADS` threads each, which
walks the region in z-chunks of `chunk` cells (a lane per cell of a chunk
plane) and marches along x inside a chunk.  A chunk row is `ROW_BYTES` of
the storage type, one L2 line: 64 cells and 8 rows in bf16, 32 cells and
16 rows in float32.
Before any write, the cells that another region reads are copied into the
edge buffer, two entries per inner region boundary b (between region b and
b + 1 along the axis), each holding the 9 slots that stream across it:

    Ex[2 b]     = f[kx(j, up),   (b + 1) xr - 1, :, :]   last plane of run b
    Ex[2 b + 1] = f[kx(j, down), (b + 1) xr,     :, :]   first plane of run b + 1
    Ey[2 b]     = f[ky(j, up),   :, (b + 1) ty - 1, :]   last row of tile b
    Ey[2 b + 1] = f[ky(j, down), :, (b + 1) ty,     :]   first row of tile b + 1

Ex is (2 (nr - 1), 9, Y, Z) at offset 0 of the buffer and Ey is
(2 (nty - 1), 9, X, Z) at offset `nx`; "up" slots have c = +1 along the
axis (pulled by the upper region), "down" slots c = -1.
"""

from __future__ import annotations

from typing import Dict, Optional

THREADS = 512  # of a block: one per cell of a chunk plane
ROW_BYTES = 128  # of a chunk row
MIN_RUN = 8  # planes: a shorter run's x edge outweighs what more blocks buy
MAX_RUN = 64  # planes: bounds the column save in shared memory
BLOCKS_PER_SM = 4  # blocks wanted per SM, so that the card stays filled


def kx(j: int, up: bool) -> int:
    """Slot k of entry j (0..8) of an x edge set: cx = +1 (up) or -1."""
    return 3 * j + (2 if up else 0)


def ky(j: int, up: bool) -> int:
    """Slot k of entry j (0..8) of a y edge set: cy = +1 (up) or -1."""
    return j % 3 + (6 if up else 0) + 9 * (j // 3)


def inplace_layout(X: int, Y: int, Z: int, sms: int, elem_bytes: int,
                   ty: Optional[int] = None, chunk: Optional[int] = None,
                   xr: Optional[int] = None) -> Dict[str, int]:
    """K5's layout of an (X, Y, Z) level of `elem_bytes`-wide storage on a
    card of `sms` SMs: chunk cells `chunk`, tile rows `ty`, planes per run
    `xr` (the kernel's own unless given: the schedule's emulation in the
    tests passes small ones), the counts of runs and tiles, the element
    counts `nx`, `ny` of Ex and Ey (Ey starts at `nx`), `edge_elems` =
    nx + ny, and `smem_elems`, the storage elements of a block's shared
    memory (plane save + column save)."""
    if min(X, Y, Z) < 1:
        raise ValueError(f"empty level {(X, Y, Z)}")
    if elem_bytes not in (2, 4):
        raise ValueError(f"storage of {elem_bytes} bytes")
    chunk = ROW_BYTES // elem_bytes if chunk is None else chunk
    ty = THREADS // chunk if ty is None else ty
    if ty < 1 or chunk < 1:
        raise ValueError(f"tile of {ty} rows, chunks of {chunk} cells")
    nty = -(-Y // ty)
    if xr is None:
        runs = -(-BLOCKS_PER_SM * sms // nty)
        runs = max(1, min(runs, -(-X // MIN_RUN)))
        xr = min(-(-X // runs), MAX_RUN)
    if xr < 1:
        raise ValueError(f"planes per run {xr}")
    nr = -(-X // xr)
    nx = 18 * (nr - 1) * Y * Z
    ny = 18 * (nty - 1) * X * Z
    return {"ty": ty, "chunk": chunk, "xr": xr, "nr": nr, "nty": nty, "nx": nx,
            "ny": ny, "edge_elems": nx + ny,
            "smem_elems": 2 * 9 * ty * chunk + 2 * 9 * xr * ty}

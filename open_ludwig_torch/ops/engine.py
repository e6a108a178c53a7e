"""Per-level kernel choice on the card.

Every level runs one of three hand-written kernels, which give the same
bits (K1, K4 and K5 share one cell body; `chip_smoke.py` holds them bit for
bit), so the choice moves speed and memory, never a result:

  "k1"       K1 `stream_collide` (A -> B; K3 on the finest level's pairs
             under fuse2=True)
  "flat"     K4 `stream_collide_flat`: K1's body with the ghost-plane reads
             compiled out (A -> B)
  "inplace"  K5 `stream_collide_inplace`: f updated in its own buffer

The rule (`card_engines`) reads only what the port observes: each level's
faces, whether it is the finest, whether it has a Bouzidi plan, and the
case's device-memory estimate (`memory.case_bytes`, through the callable
the caller passes) against the card's capacity (`memory.card_capacity`:
its memory less a reserve).  A level with an interface face runs K1: it
reads its ghost planes.  An interface-free level runs K4, faster than K1
on a large level (0.606 against 0.643 ms a step in bf16 at 10.8M cells,
from a CUDA graph) and within 4% of it on a wind tunnel of 0.2M cells
(0.0117 against 0.0113 ms; NVIDIA H100 80GB HBM3, 700 W), unless it is the
finest level, whose K1 is what fuse2=True pairs on K3, or a Bouzidi level;
those run K1.  Then the interface-free levels, in order, each move to K5
while the estimate with the levels decided so far exceeds the capacity: K5
holds no second f, but took 0.120-0.136 ns a cell a coarse step on the
sweep rows against K1 -> K2's 0.063-0.066 (same card,
`tools/probe_sweep_rows.py`).  The rule asks no backend: the CPU tests run
it with a capacity, or none (no limit).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..core.patch import BC_INTERFACE, PatchLevel


def _gb(nbytes: int) -> str:
    return f"{nbytes / 1e9:.1f} GB"


def card_engines(patches: List[PatchLevel], capacity: Optional[int],
                 need: Callable[[List[str]], int]) -> List[Tuple[str, str]]:
    """(engine, reason) per level by the card's rule (module docstring) for
    a capacity in bytes per card (None: no limit).  `need(engines)` is the
    case's device-memory estimate on its most loaded card with each level
    on `engines` (`memory.case_bytes`)."""
    last = len(patches) - 1
    engs, why, free = [], [], []
    for li, p in enumerate(patches):
        if BC_INTERFACE in p.face_bc:
            engs.append("k1")
            why.append("interface faces: K1 reads the ghost planes")
            continue
        free.append(li)
        if li == last or p.bouzidi is not None:
            engs.append("k1")
            why.append("interface-free " + ("finest" if li == last else "Bouzidi")
                       + " level: K1 (fuse2=True pairs a finest K1 level on K3)")
        else:
            engs.append("flat")
            why.append("interface-free, neither finest nor Bouzidi: K4 (K1's "
                       "body without the ghost-plane reads)")
    for li in free:
        nbytes = need(engs)
        if capacity is None:
            why[li] += f"; A->B {_gb(nbytes)} (no memory limit given)"
        elif nbytes <= capacity:
            why[li] += f"; A->B {_gb(nbytes)} fits {_gb(capacity)}"
        else:
            engs[li] = "inplace"
            why[li] = (f"interface-free: K5 in place, A->B {_gb(nbytes)} exceeds "
                       f"{_gb(capacity)}")
    total = need(engs) if "inplace" in engs else 0
    if capacity is not None and total > capacity:
        for li in free:
            if engs[li] == "inplace":
                why[li] += f"; with K5 the case's {_gb(total)} still exceeds it"
    return list(zip(engs, why))

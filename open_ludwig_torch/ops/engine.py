"""Per-level kernel choice, made as the JAX package's dispatch makes it.

The JAX package picks one Pallas step per level
(`open_ludwig_tpu/solver_dense.py:233-336`): the flat-(y,z) kernel on a
level the patch builder stored flat, the 1-D kernel where a whole
x-plane window fits VMEM, the in-place (x, y)-chunked 2-D kernel where
only that fits, and the XLA path otherwise.  The port runs a hand-written
kernel on every level and maps that choice to its engines:

  "flat"     K4 `stream_collide_flat` (replaces make_pallas_step_flat)
  "inplace"  K5 `stream_collide_inplace` (replaces make_pallas_step_2d,
             in place and unfused)
  "k1"       K1 `stream_collide` (K3 on the finest level's pairs); also
             where the reference falls back to XLA

The gates are numpy ports of `_pallas_fits` (solver_dense.py:95-102),
`_chunks_2d_vmem_est` / `choose_2d_chunks` (ops/pallas_step.py:1526-1572,
with alias_f=True as production passes it), `choose_flat_px`
(:2079-2097) and the structural and shape gate of
`core/patch._use_flat_yz` (core/patch.py:135-183).  They are evaluated on
the reference's padded dims (ceil(X, n), ceil(Y, 8), ceil(Z, 128)) for
n = `shard_nx` devices (core/patch.py:276-280; x is padded to the device
count there, `build_patches(x_multiple)`), each device's slab ceil(X, n)
/ n planes, and never ask for a backend: the choice is the same on the
CPU and the GPU, so the CPU tests run the card's schedule.  The port's
own slabs are unpadded (`parallel.patch_shard.slab_bounds`); only the
choice reads the reference's padded extent.

That is the reference's rule (`level_engines`, held to the JAX builder by
the tests).  The card's rule (`card_engines`) is laid over it, since the
H100 has no VMEM window: K1 has no plane limit, and the card's limit is
its memory.  A level the reference runs in place (K5) runs K1 (A -> B)
where the case's device-memory estimate with that level stepping A -> B
(`memory.case_bytes`, through the callable the caller passes) fits the
card's capacity (`memory.card_capacity`: its memory less a reserve); it
stays on K5 only where it does not fit.  K5 is no faster there: in turns
on the sweep rows it took 0.120-0.136 ns a cell a coarse step against
K1 -> K2's 0.063-0.066 (NVIDIA H100 80GB HBM3, 700 W,
`tools/probe_sweep_rows.py`).  Flat levels stay K4 and K1 levels K1.  The
rule asks no backend: the CPU tests run it with a capacity, or none (no
limit).
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

from ..core.patch import BC_INTERFACE, PatchLevel
from . import storage

log = logging.getLogger("open_ludwig_torch")

_SLOTS = 4  # the TPU kernels' rotating DMA slots (ops/pallas_step.py:49)
_PALLAS_VMEM_BUDGET = 52 * 2**20  # solver_dense.py:95


def _ceil(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def ref_padded(patch: PatchLevel, shard_nx: int = 1) -> Tuple[int, int, int]:
    """The JAX package's array dims of the level cut over `shard_nx`
    devices (x padded to a multiple of it)."""
    X, Y, Z = patch.interior
    return _ceil(X, max(int(shard_nx), 1)), _ceil(Y, 8), _ceil(Z, 128)


def flat_m(patch: PatchLevel) -> int:
    """Lane extent of the flat layout: ceil(Y * Z, 128)."""
    return _ceil(int(patch.interior[1]) * int(patch.interior[2]), 128)


def pallas_fits(patch: PatchLevel, store_bf16: bool) -> bool:
    """Whether one x-plane window of the 1-D kernel fits its VMEM budget
    (the 3-D layout's form of solver_dense._pallas_fits)."""
    _, YS, ZS = ref_padded(patch)
    fb = 2 if store_bf16 else 4
    est1 = (4 * (27 * fb + 12) + 2 * 9 + 2 * (27 * fb + 16)) * YS * ZS
    return est1 < _PALLAS_VMEM_BUDGET


def chunks_2d_vmem_est(PX: int, PY: int, ZS: int, f_bytes: int, YS: int = 0,
                       alias_f: bool = False) -> int:
    """Per-chunk VMEM footprint of the 2-D kernel (pallas_step.py:1526)."""
    plane = PX * PY * ZS
    halo = PY * ZS
    est = (
        _SLOTS * (27 * f_bytes + 3 * 4) * (plane + 2 * halo)
        + 2 * 9 * plane
        + 2 * (27 * f_bytes + 4 + 3 * 4) * plane
    )
    if alias_f:
        assert YS and YS % PY == 0
        est += 2 * (YS // PY) * 27 * (PY + 8) * ZS * f_bytes
    return est


def choose_2d_chunks(patch: PatchLevel, store_bf16: bool, alias_f: bool = True,
                     px_c=(16, 8, 4), py_c=(32, 16, 8), shard_nx: int = 1
                     ) -> Optional[Tuple[int, int]]:
    """(PX, PY) of the 2-D kernel, or None (pallas_step.py:1545), on a
    level the reference stores in 3-D, PX dividing each device's slab."""
    XS, YS, ZS = ref_padded(patch, shard_nx)
    if BC_INTERFACE in patch.face_bc:
        return None
    XL = XS // max(int(shard_nx), 1)
    fbytes = 2 if store_bf16 else 4
    for PX in px_c:
        if XL % PX:
            continue
        for PY in py_c:
            if YS % PY:
                continue
            if chunks_2d_vmem_est(PX, PY, ZS, fbytes, YS=YS,
                                  alias_f=alias_f) < 64 * 2**20:
                return PX, PY
    return None


def choose_flat_px(XL: int, M: int, f_bytes: int) -> Optional[int]:
    """PX of the flat kernel, or None where it cannot run
    (pallas_step.py:2079)."""
    per = (_SLOTS * (27 * f_bytes + 12) + 2 * 9 + 2 * (27 * f_bytes + 16)) * M
    for cand in (16, 8):
        if XL % cand == 0 and cand * per < 36 * 2**20:
            return cand
    if XL % 8 == 0 and 8 * per < 100 * 2**20:
        return 8
    if XL % 16 == 0 and 16 * per < 100 * 2**20:
        return 16
    return None


def flat_gate(mode: str, patch: PatchLevel, is_finest: bool,
              store_bf16: bool, shard_nx: int = 1) -> Tuple[bool, str]:
    """The reference's `_use_flat_yz` without its backend check, for
    `shard_nx` devices (`cfg.devices`, core/patch.py:153-170): (whether the
    level runs flat, why)."""
    if mode == "off":
        return False, "flat_coarse: off"
    if any(bc == BC_INTERFACE for bc in patch.face_bc):
        return False, "interface faces"
    if is_finest or patch.bouzidi is not None:
        return False, "finest level or Bouzidi level"
    n = max(int(shard_nx), 1)
    XS, YS, ZS = ref_padded(patch, n)
    M = flat_m(patch)
    if M >= YS * ZS:
        return False, f"flat M={M} removes no padding of the {YS}x{ZS} plane"
    px = choose_flat_px(XS // n, M, 2 if store_bf16 else 4)
    if px is None:
        if mode == "on":
            log.warning(
                "[Patch] level %d: flat_coarse=on but the Pallas flat step "
                "is unavailable on this backend/shape; building the level "
                "in 3-D layout instead", patch.level_id)
        return False, (f"no flat PX for x extent {patch.interior[0]}"
                       + (f" (slabs of {XS // n} on {n} devices)" if n > 1 else "")
                       + f" at M={M}")
    return True, (f"interface-free, flat M={M} < padded plane {YS}x{ZS}, "
                  f"PX={px} (flat_coarse: {mode})")


def choose_engine(mode: str, patch: PatchLevel, is_finest: bool,
                  store_bf16: bool, shard_nx: int = 1) -> Tuple[str, str]:
    """(engine, reason) of one level: the reference's dispatch order,
    solver_dense.py:233-336, Pallas on, the level cut over `shard_nx`
    devices (its x padded to a multiple of them, so every gate's
    divisibility holds but the per-slab PX)."""
    flat, why = flat_gate(mode, patch, is_finest, store_bf16, shard_nx)
    if flat:
        return "flat", why
    _, YS, ZS = ref_padded(patch)
    if pallas_fits(patch, store_bf16):
        return "k1", f"1-D window fits; not flat: {why}"
    chunks = choose_2d_chunks(patch, store_bf16, alias_f=True, shard_nx=shard_nx)
    if chunks is not None:
        return "inplace", (f"plane {YS}x{ZS} exceeds the 1-D window budget; "
                           f"2-D chunks {chunks} fit (in place)")
    return "k1", (f"plane {YS}x{ZS} fits no Pallas window; the reference "
                  "falls back to XLA here")


def level_engines(cfg, patches: List[PatchLevel], shard_nx: int = 1
                  ) -> List[Tuple[str, str]]:
    """(engine, reason) per level for `cfg`'s precision and flat_coarse on
    `shard_nx` devices."""
    bf16 = storage.normalize_precision(cfg.precision) == storage.STORE_BF16
    mode = str(getattr(cfg, "flat_coarse", "auto"))
    last = len(patches) - 1
    return [choose_engine(mode, p, li == last, bf16, shard_nx)
            for li, p in enumerate(patches)]


# ---- the card's rule ----

_NAMES = {"k1": "K1", "flat": "K4", "inplace": "K5"}


def card_engines(patches: List[PatchLevel], precision: str, capacity: Optional[int],
                 need: Callable[[List[str]], int], flat_coarse: str = "auto",
                 n_slabs: int = 1) -> List[Tuple[str, str]]:
    """(engine, reason) per level by the card's rule (module docstring) for
    `precision`, a capacity in bytes per card (None: no limit) and the
    reference's rule on `n_slabs` x slabs.  `need(engines)` is the case's
    device-memory estimate on its most loaded card with each level on
    `engines` (`memory.case_bytes`).  Levels the reference runs in place
    are taken in order, each on K1 where the estimate, the levels before
    it as decided, fits.  The reason names both rules."""
    bf16 = storage.normalize_precision(precision) == storage.STORE_BF16
    last = len(patches) - 1
    ref = [choose_engine(flat_coarse, p, li == last, bf16, n_slabs)
           for li, p in enumerate(patches)]
    engs = [e for e, _ in ref]
    out = []
    for li, (eng, why) in enumerate(ref):
        head = f"the JAX package runs {_NAMES[eng]} here ({why}); "
        if eng != "inplace":
            out.append((eng, head + f"the card runs {_NAMES[eng]} too"))
            continue
        trial = engs[:li] + ["k1"] + engs[li + 1:]
        nbytes = need(trial)
        if capacity is None or nbytes <= capacity:
            engs[li] = "k1"
            out.append(("k1", head + f"the card runs K1: A->B {nbytes / 1e9:.1f} GB "
                        + ("(no memory limit given)" if capacity is None
                           else f"fits {capacity / 1e9:.1f} GB")))
        else:
            out.append(("inplace", head + f"the card keeps K5: A->B {nbytes / 1e9:.1f} "
                        f"GB exceeds {capacity / 1e9:.1f} GB"))
    return out

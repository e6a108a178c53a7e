"""Nested dense-patch layout without TPU tile padding.

The patch boxes are the JAX package's (`open_ludwig_tpu/core/patch.py:
build_patches`): one dense box per refinement level around the geometry
and the wake, with the fine boxes grown toward the TPU tile (z to 128,
y to 8 cells) inside their parent-containment bounds.  That growth decides
which cells get refined, which is physics, so the port keeps it and both
packages solve the same boxes.  What the port drops is the storage pad
(y -> 8, z -> 128 of `padded`): here `padded == interior` on every level
and each static field is cut to the interior.  Every level's state is
(27, X, Y, Z); on a level the reference stores flat-(y, z) (`flat_yz`),
that is already the flat (27, X, Y * Z) layout without its 128-lane pad,
so K4 reads it as flat (`ops/engine.py` makes that choice per level, from
the user's `flat_coarse`) and `PatchLevel.flat_yz` stays False here.

The reference `build_patches` is called with `flat_coarse="off"` and
`devices=1`, which returns before its only jax import (the flat-layout
availability check); `tests/test_torch_storage_patch.py` asserts in a
subprocess that building and stepping the port never imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import List

from open_ludwig_tpu.config import CaseConfig
from open_ludwig_tpu.core.patch import (  # noqa: F401  (re-exported)
    BC_INLET,
    BC_INTERFACE,
    BC_MIRROR_Y,
    BC_MIRROR_Z,
    BC_OUTLET,
    PatchLevel,
)
from open_ludwig_tpu.core.patch import build_patches as _build_patches_ref
from open_ludwig_tpu.geometry import TriMesh
from open_ludwig_tpu.scaling import DomainParams


def trim_patch(p: PatchLevel) -> PatchLevel:
    """The same level with its static fields cut to the interior."""
    X, Y, Z = p.interior
    return dataclasses.replace(
        p,
        padded=tuple(p.interior),
        obstacle=p.obstacle[:X, :Y, :Z].copy(),
        sponge=p.sponge[:X, :Y, :Z].copy(),
        wall_dist=p.wall_dist[:X, :Y, :Z].copy(),
        flat_yz=False,
    )


def build_patches(
    cfg: CaseConfig, mesh: TriMesh, params: DomainParams
) -> List[PatchLevel]:
    """Unpadded patch levels for `cfg` (single device)."""
    ref_cfg = dataclasses.replace(cfg, flat_coarse="off", devices=1)
    return [trim_patch(p) for p in _build_patches_ref(ref_cfg, mesh, params)]

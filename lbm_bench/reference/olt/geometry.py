# Frozen copy of open_ludwig_torch/geometry.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""STL geometry loading and triangle-mesh properties (host-side, numpy).

The port's own copy of `open_ludwig_tpu/geometry.py`.  It replicates the
reference geometry module (reference: src/geometry.jl) with fully
vectorized numpy instead of per-triangle loops:
  - binary STL parsed with one structured-dtype read,
  - ASCII STL parsed by scanning 'vertex' lines,
  - format sniffing by the 'solid' prefix + exact-size check
    (reference: src/geometry.jl:167-180),
  - normals / areas / centers from one cross-product batch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TriMesh:
    """Triangle soup. vertices: (n_tri, 3, 3) float64 [tri, corner, xyz]."""

    vertices: np.ndarray
    normals: np.ndarray  # (n_tri, 3) unit outward normals from vertex winding
    areas: np.ndarray  # (n_tri,)
    centers: np.ndarray  # (n_tri, 3)
    min_bounds: Tuple[float, float, float]
    max_bounds: Tuple[float, float, float]

    @property
    def n_triangles(self) -> int:
        return self.vertices.shape[0]


def _mesh_from_vertices(verts: np.ndarray) -> TriMesh:
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    cp = np.cross(e1, e2)
    norm = np.linalg.norm(cp, axis=1)
    areas = 0.5 * norm
    normals = np.zeros_like(cp)
    ok = areas > 1e-12
    normals[ok] = cp[ok] / (2.0 * areas[ok, None])
    centers = verts.mean(axis=1)
    mn = verts.reshape(-1, 3).min(axis=0)
    mx = verts.reshape(-1, 3).max(axis=0)
    return TriMesh(verts, normals, areas, centers, tuple(mn), tuple(mx))


def _parse_binary(path: str, scale: float) -> np.ndarray:
    with open(path, "rb") as f:
        f.seek(80)
        count = int(np.frombuffer(f.read(4), "<u4")[0])
        rec = np.dtype(
            [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        )
        data = np.frombuffer(f.read(count * rec.itemsize), dtype=rec, count=count)
    return data["v"].astype(np.float64) * scale


def _parse_ascii(path: str, scale: float) -> np.ndarray:
    coords = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("vertex"):
                parts = s.split()
                if len(parts) >= 4:
                    coords.append((float(parts[1]), float(parts[2]), float(parts[3])))
    arr = np.asarray(coords, np.float64) * scale
    n = (len(arr) // 3) * 3
    return arr[:n].reshape(-1, 3, 3)


def load_mesh(path: str, scale: float = 1.0) -> TriMesh:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"STL file not found: {path}")
    size = os.path.getsize(path)
    is_binary = True
    if size < 84:
        is_binary = False
    else:
        with open(path, "rb") as f:
            header = f.read(5)
            if header.lower().startswith(b"solid"):
                f.seek(80)
                count = int(np.frombuffer(f.read(4), "<u4")[0])
                if size != 84 + count * 50:
                    is_binary = False
    verts = _parse_binary(path, scale) if is_binary else _parse_ascii(path, scale)
    if len(verts) == 0:
        raise ValueError(f"No triangles loaded from {path}")
    return _mesh_from_vertices(np.ascontiguousarray(verts))


# ---------------------------------------------------------------------------
# Synthetic geometries for tests / bundled cases (no external assets needed).
# ---------------------------------------------------------------------------

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


def save_binary_stl(path: str, verts: np.ndarray) -> None:
    """Write a binary STL from (n, 3, 3) vertices (for synthesized test cases)."""
    verts = np.asarray(verts, np.float64)
    n = verts.shape[0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    cp = np.cross(e1, e2)
    nrm = np.linalg.norm(cp, axis=1, keepdims=True)
    normals = np.where(nrm > 1e-30, cp / np.maximum(nrm, 1e-30), 0.0)
    rec = np.zeros(n, dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
    rec["n"] = normals
    rec["v"] = verts
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.uint32(n).tobytes())
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# Synthetic geometries for tests / bundled cases (no external assets needed).
# ---------------------------------------------------------------------------


def make_cube(edge: float = 1.0, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """12-triangle axis-aligned cube, outward winding. Returns (12, 3, 3)."""
    h = edge / 2.0
    c = np.asarray(center, np.float64)
    v = np.array(
        [[x, y, z] for z in (-h, h) for y in (-h, h) for x in (-h, h)], np.float64
    ) + c
    # 8 corners indexed bit-wise: bit0=x, bit1=y, bit2=z
    faces = [
        (0, 2, 1), (1, 2, 3),  # z min (normal -z)
        (4, 5, 6), (5, 7, 6),  # z max (+z)
        (0, 1, 4), (1, 5, 4),  # y min (-y)
        (2, 6, 3), (3, 6, 7),  # y max (+y)
        (0, 4, 2), (2, 4, 6),  # x min (-x)
        (1, 3, 5), (3, 7, 5),  # x max (+x)
    ]
    return v[np.asarray(faces)]


def make_icosphere(radius: float = 0.5, center=(0.0, 0.0, 0.0), subdiv: int = 3) -> np.ndarray:
    """Subdivided icosahedron sphere. subdiv=3 -> 1280 triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    pts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    tris = pts[faces]
    for _ in range(subdiv):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    tris /= np.linalg.norm(tris, axis=2, keepdims=True)
    return tris * radius + np.asarray(center, np.float64)


def make_naca_wing(
    chord: float = 1.0,
    span: float = 2.0,
    thickness: float = 0.12,
    alpha_deg: float = 0.0,
    n_chord: int = 40,
    n_span: int = 8,
) -> np.ndarray:
    """Extruded NACA 00xx wing as a closed triangle mesh (for the Wing-class
    bundled cases), pitched by alpha about the quarter chord."""
    xc = 0.5 * (1 - np.cos(np.linspace(0, np.pi, n_chord)))  # cosine spacing
    yt = 5 * thickness * (
        0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc**2
        + 0.2843 * xc**3 - 0.1036 * xc**4
    )
    # closed loop: upper surface TE->LE then lower LE->TE
    loop_x = np.concatenate([xc[::-1], xc[1:]]) * chord
    loop_z = np.concatenate([yt[::-1], -yt[1:]]) * chord
    a = np.deg2rad(alpha_deg)
    xr = (loop_x - 0.25 * chord) * np.cos(a) + loop_z * np.sin(a) + 0.25 * chord
    zr = -(loop_x - 0.25 * chord) * np.sin(a) + loop_z * np.cos(a)
    m = len(loop_x)
    ys = np.linspace(-span / 2, span / 2, n_span + 1)
    tris = []
    # side surface quads
    for j in range(n_span):
        for i in range(m - 1):
            p00 = (xr[i], ys[j], zr[i])
            p01 = (xr[i + 1], ys[j], zr[i + 1])
            p10 = (xr[i], ys[j + 1], zr[i])
            p11 = (xr[i + 1], ys[j + 1], zr[i + 1])
            tris.append((p00, p01, p11))
            tris.append((p00, p11, p10))
    # end caps (fan from the mid-chord point)
    for y, flip in ((ys[0], True), (ys[-1], False)):
        cx, cz = xr.mean(), zr.mean()
        for i in range(m - 1):
            a3 = (cx, y, cz)
            b3 = (xr[i], y, zr[i])
            c3 = (xr[i + 1], y, zr[i + 1])
            tris.append((a3, c3, b3) if flip else (a3, b3, c3))
    out = np.asarray(tris, np.float64)
    # enforce outward winding (positive signed volume)
    vol = np.einsum("ij,ij->i", out[:, 0], np.cross(out[:, 1], out[:, 2])).sum() / 6
    if vol < 0:
        out = out[:, ::-1, :]
    return out

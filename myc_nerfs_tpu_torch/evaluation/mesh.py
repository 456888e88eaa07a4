"""Mesh export: a dense density query, an isosurface, a PLY/OBJ file
(counterpart of myc_nerfs_tpu/evaluation/mesh.py; barf extract_mesh.py:18-46,
tensorf utils.py:146-207 convert_sdf_samples_to_ply).

The isosurface is this module's own copy of the JAX package's numpy
marching tetrahedra (ops/native.py::marching_tets_numpy): six tetrahedra
per cube, the same tables, vertices and triangles in the same order. The
cubes the surface crosses are found at once with numpy before the loop.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
_CUBE_OFF = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_SINGLE = {0x1: (0, (1, 2, 3)), 0x2: (1, (0, 3, 2)), 0x4: (2, (0, 1, 3)),
           0x8: (3, (0, 2, 1)), 0xE: (0, (1, 3, 2)), 0xD: (1, (0, 2, 3)),
           0xB: (2, (0, 3, 1)), 0x7: (3, (0, 1, 2))}
_DOUBLE = {0x3: ((0, 2), (0, 3), (1, 3), (1, 2), False),
           0xC: ((0, 2), (0, 3), (1, 3), (1, 2), True),
           0x5: ((0, 1), (2, 1), (2, 3), (0, 3), False),
           0xA: ((0, 1), (2, 1), (2, 3), (0, 3), True),
           0x6: ((1, 0), (2, 0), (2, 3), (1, 3), True),
           0x9: ((1, 0), (2, 0), (2, 3), (1, 3), False)}


def marching_tets(grid: np.ndarray, iso: float) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of grid [nx, ny, nz] at ``iso``: (verts [V, 3] float32 in
    grid-index coords, tris [T, 3] int32)."""
    grid = np.asarray(grid, np.float32)
    nx, ny, nz = grid.shape
    coords = {}
    verts = []
    tris = []

    def edge_vert(pa, pb):
        ga, gb = (pa[0] * ny + pa[1]) * nz + pa[2], (pb[0] * ny + pb[1]) * nz + pb[2]
        if ga > gb:
            pa, pb, ga, gb = pb, pa, gb, ga
        key = (ga, gb)
        if key not in coords:
            fa, fb = grid[tuple(pa)], grid[tuple(pb)]
            t = np.clip((iso - fa) / (fb - fa), 0.0, 1.0)
            coords[key] = len(verts)
            verts.append(np.asarray(pa, np.float32) + t * (np.asarray(pb) - np.asarray(pa)))
        return coords[key]

    def emit(a, b, c):
        if a != b and b != c and a != c:
            tris.append((a, b, c))

    above = grid > iso
    corners_above = np.stack([above[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                              for dx, dy, dz in _CUBE_OFF])
    crossed = corners_above.any(0) & ~corners_above.all(0)
    for x, y, z in np.argwhere(crossed):
        corners = np.array([x, y, z]) + _CUBE_OFF
        f = grid[corners[:, 0], corners[:, 1], corners[:, 2]]
        for tet in _TETS:
            p = corners[tet]
            mask = int(((f[tet] > iso) * [1, 2, 4, 8]).sum())
            if mask in (0x0, 0xF):
                continue
            if mask in _SINGLE:
                i, rest = _SINGLE[mask]
                emit(*[edge_vert(p[i], p[j]) for j in rest])
            else:
                e0, e1, e2, e3, flip = _DOUBLE[mask]
                a, b, c, d = (edge_vert(p[e[0]], p[e[1]]) for e in (e0, e1, e2, e3))
                if flip:
                    emit(a, c, b)
                    emit(a, d, c)
                else:
                    emit(a, b, c)
                    emit(a, c, d)
    v = np.stack(verts) if verts else np.zeros((0, 3), np.float32)
    return v, np.asarray(tris, np.int32).reshape(-1, 3)


@torch.no_grad()
def query_density_grid(density_fn: Callable[[torch.Tensor], torch.Tensor], res: int,
                       vrange: Tuple[float, float], chunk: int = 16384,
                       device=None) -> np.ndarray:
    """density_fn on the (res+1)^3 lattice over vrange per axis
    (extract_mesh.py:26-35) -> numpy [res+1, res+1, res+1]."""
    from ..models.tensorf import linspace_f32

    t = linspace_f32(vrange[0], vrange[1], res + 1, device)
    pts = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), dim=-1).reshape(-1, 3)
    out = torch.cat([density_fn(pts[a:a + chunk]) for a in range(0, pts.shape[0], chunk)])
    return out.cpu().numpy().reshape(res + 1, res + 1, res + 1)


def extract_mesh(density_fn: Callable[[torch.Tensor], torch.Tensor], res: int = 128,
                 vrange: Tuple[float, float] = (-1.2, 1.2), thresh: float = 25.0,
                 chunk: int = 16384, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The isosurface of density_fn at ``thresh`` over vrange^3: (verts
    [V, 3] in world coordinates, tris [T, 3]) (extract_mesh.py:37-41, the
    vertices / res - 0.5 centring generalised to the query range)."""
    grid = query_density_grid(density_fn, res, vrange, chunk, device)
    verts, tris = marching_tets(grid, thresh)
    lo, hi = vrange
    return verts / res * (hi - lo) + lo, tris


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """OBJ writer (replaces trimesh.export, extract_mesh.py:43-45)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """ASCII PLY writer (replaces plyfile, utils.py:186-207)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def convert_density_samples_to_ply(density_grid: np.ndarray, path: str, bbox,
                                   level: float = 0.5) -> Tuple[int, int]:
    """convert_sdf_samples_to_ply (utils.py:146-207): the grid [nx, ny, nz]
    spans bbox; faces reversed like the reference's. Returns (vertices,
    faces)."""
    verts, tris = marching_tets(np.asarray(density_grid, np.float32), level)
    bbox = np.asarray(bbox, np.float32)
    voxel = (bbox[1] - bbox[0]) / (np.asarray(density_grid.shape) - 1)
    save_ply(path, bbox[0] + verts * voxel, tris[:, ::-1])
    return len(verts), len(tris)

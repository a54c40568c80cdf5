"""Model voxelization (counterpart of ``lumixengine_tpu/renderer/voxels.py``):
a host bake tool that marks a model's points or sampled triangle surface in
an occupancy grid, and a neighbourhood-occupancy ambient-occlusion field
from it (the TDAO bake source).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def voxelize_points(points: np.ndarray, resolution: int = 32,
                    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Occupancy grid [R,R,R] from points [N,3]. Returns (grid, mins, cell)."""
    points = np.asarray(points, np.float32)
    if bounds is None:
        mins = points.min(axis=0) - 1e-4
        maxs = points.max(axis=0) + 1e-4
    else:
        mins, maxs = (np.asarray(b, np.float32) for b in bounds)
    cell = (maxs - mins) / resolution
    cell = np.where(cell <= 0, 1e-6, cell)
    idx = np.clip(((points - mins) / cell).astype(np.int32), 0, resolution - 1)
    grid = np.zeros((resolution,) * 3, bool)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return grid, mins, cell


def voxelize_triangles(vertices: np.ndarray, indices: np.ndarray,
                       resolution: int = 32, samples_per_tri: int = 16,
                       bounds=None):
    """Surface voxelization: sample barycentric points on each triangle
    (numpy's default_rng(0)) and mark their cells, the vertices too."""
    vertices = np.asarray(vertices, np.float32)
    tris = vertices[np.asarray(indices, np.int64).reshape(-1, 3)]
    rng = np.random.default_rng(0)
    u = rng.random((len(tris), samples_per_tri, 1)).astype(np.float32)
    v = rng.random((len(tris), samples_per_tri, 1)).astype(np.float32)
    over = (u + v) > 1.0
    u = np.where(over, 1.0 - u, u)
    v = np.where(over, 1.0 - v, v)
    pts = (tris[:, None, 0] * (1 - u - v) + tris[:, None, 1] * u + tris[:, None, 2] * v)
    pts = np.concatenate([pts.reshape(-1, 3), vertices])
    return voxelize_points(pts, resolution, bounds)


def occupancy_ao(grid: np.ndarray, max_dist: int = 4) -> np.ndarray:
    """Cheap ambient-occlusion field: fraction of occupied cells within a
    Chebyshev neighborhood, per cell (the TDAO bake source)."""
    r = grid.shape[0]
    acc = np.zeros(grid.shape, np.float32)
    count = 0
    for dx in range(-max_dist, max_dist + 1):
        for dy in range(-max_dist, max_dist + 1):
            for dz in range(-max_dist, max_dist + 1):
                if dx == dy == dz == 0:
                    continue
                shifted = np.zeros_like(grid)
                sx = slice(max(dx, 0), r + min(dx, 0))
                tx = slice(max(-dx, 0), r + min(-dx, 0))
                sy = slice(max(dy, 0), r + min(dy, 0))
                ty = slice(max(-dy, 0), r + min(-dy, 0))
                sz = slice(max(dz, 0), r + min(dz, 0))
                tz = slice(max(-dz, 0), r + min(-dz, 0))
                shifted[tx, ty, tz] = grid[sx, sy, sz]
                acc += shifted
                count += 1
    return acc / count

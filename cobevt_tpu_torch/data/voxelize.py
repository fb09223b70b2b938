"""Host-side point-cloud voxelization (pillar generation).

Counterpart of ``cobevt_tpu/data/voxelize.py`` (the reference's spconv
voxel generator, ``SpVoxelPreprocessor``): a numpy pillarizer that emits the
static padded layout the pillar encoder consumes: (max_voxels, max_points,
4) features, (max_voxels,) counts, (max_voxels, 4) [0, z, y, x] coords and
a valid mask.  The JAX package fills the voxels in a Python loop; here one
scatter fills them all, and every array is bit-equal to its.  Voxels are
kept in flat-cell order, the first ``max_voxels`` of them, and each keeps
its first ``max_points_per_voxel`` points in cloud order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _cells(points, voxel_size, point_cloud_range):
    """(points in range, their flat cell ids, grid (nx, ny, nz))."""
    pr = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    grid = np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)  # nx, ny, nz

    keep = np.all((points[:, :3] >= pr[:3]) &
                  (points[:, :3] < pr[3:] - 1e-9), axis=1)
    pts = points[keep]
    cell = ((pts[:, :3] - pr[:3]) / vs).astype(np.int64)
    cell = np.minimum(cell, grid - 1)
    flat = (cell[:, 2] * grid[1] * grid[0] + cell[:, 1] * grid[0] +
            cell[:, 0])
    return pts, flat, grid


def occupied_voxels(points: np.ndarray, voxel_size, point_cloud_range) -> int:
    """How many voxels the cloud's in-range points occupy: what
    :func:`voxelize_points` keeps before its ``max_voxels`` cut."""
    _, flat, _ = _cells(points, voxel_size, point_cloud_range)
    return int(len(np.unique(flat)))


def voxelize_points(points: np.ndarray,
                    voxel_size: Tuple[float, float, float],
                    point_cloud_range,
                    max_voxels: int = 8000,
                    max_points_per_voxel: int = 32):
    """points: (N, 4) [x y z intensity]."""
    pts, flat, grid = _cells(points, voxel_size, point_cloud_range)

    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    pts_sorted = pts[order]
    uniq, starts, counts = np.unique(flat_sorted, return_index=True,
                                     return_counts=True)

    n_vox = min(len(uniq), max_voxels)
    features = np.zeros((max_voxels, max_points_per_voxel,
                         points.shape[1]), np.float32)
    num_points = np.zeros((max_voxels,), np.int32)
    coords = np.zeros((max_voxels, 4), np.int32)
    mask = np.zeros((max_voxels,), bool)

    # each sorted point's voxel and its rank inside the voxel
    voxel = np.repeat(np.arange(len(uniq)), counts)
    rank = np.arange(len(flat_sorted)) - starts[voxel]
    take = (voxel < n_vox) & (rank < max_points_per_voxel)
    features[voxel[take], rank[take]] = pts_sorted[take]
    num_points[:n_vox] = np.minimum(counts[:n_vox], max_points_per_voxel)
    f = uniq[:n_vox]
    coords[:n_vox, 1] = f // (grid[1] * grid[0])
    coords[:n_vox, 2] = (f % (grid[1] * grid[0])) // grid[0]
    coords[:n_vox, 3] = f % grid[0]
    mask[:n_vox] = True
    return {"voxel_features": features, "voxel_num_points": num_points,
            "voxel_coords": coords, "voxel_mask": mask,
            "grid_size": tuple(int(g) for g in grid)}

"""Small LiDAR-track helpers.

Counterpart of ``cobevt_tpu/models/lidar/misc.py`` (reference
``mean_vfe.py`` and ``height_compression.py``).
"""

from __future__ import annotations

import torch


def mean_vfe(voxel_features, voxel_num_points):
    """(N, P, C) zero-padded points -> (N, C) per-voxel mean."""
    P = voxel_features.shape[1]
    mask = (torch.arange(P, device=voxel_features.device)[None]
            < voxel_num_points[:, None]).to(voxel_features.dtype)
    s = (voxel_features * mask[..., None]).sum(dim=1)
    return s / voxel_num_points.clamp(min=1).to(
        voxel_features.dtype)[:, None]


def height_compression(dense_voxel_grid):
    """(B, D, H, W, C) -> (B, H, W, D*C) dense BEV features."""
    B, D, H, W, C = dense_voxel_grid.shape
    return dense_voxel_grid.permute(0, 2, 3, 1, 4).reshape(B, H, W, D * C)

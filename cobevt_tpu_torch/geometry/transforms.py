"""Pose and grid math used by the CorpBEVT forward.

Counterpart of the parts of ``cobevt_tpu/geometry/transforms.py`` the
serving path uses: the host-side numpy grids are copied as they are, the
traced functions take torch tensors and compute in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def get_view_matrix(h: int = 200, w: int = 200, h_meters: float = 100.0,
                    w_meters: float = 100.0,
                    offset: float = 0.0) -> np.ndarray:
    """3x3 matrix mapping ego-frame meters (x fwd, y left) to BEV pixels."""
    sh = h / h_meters
    sw = w / w_meters
    return np.float32([
        [0.0, -sw, w / 2.0],
        [-sh, 0.0, h * offset + h / 2.0],
        [0.0, 0.0, 1.0],
    ])


def generate_grid(height: int, width: int) -> np.ndarray:
    """Homogeneous normalized pixel grid, shape (3, height, width).

    Channel 0 is x in [0, 1] (varies along width), channel 1 is y in
    [0, 1] (varies along height), channel 2 is 1.
    """
    xs = np.linspace(0.0, 1.0, width, dtype=np.float32)
    ys = np.linspace(0.0, 1.0, height, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)                      # (h, w) each
    ones = np.ones_like(gx)
    return np.stack([gx, gy, ones], axis=0)


def discretize_transformation(matrix, discrete_ratio: float,
                              downsample_rate: float):
    """(..., 4, 4) SE(3) -> (..., 2, 3) pixel-space 2D affine, f32.

    Keeps rows {0,1} and columns {0,1,3}; divides the translation column
    by ``discrete_ratio * downsample_rate`` (meters -> feature pixels).
    """
    sub = matrix[..., :2, :][..., [0, 1, 3]].float()
    scale = 1.0 / (discrete_ratio * downsample_rate)
    return torch.cat([sub[..., :2], sub[..., 2:] * scale], dim=-1)


def rotation_matrix_about_center(M, dsize):
    """Recentre the linear part of a (..., 2, 3) affine about the image
    center: out = R (p - c) + c with R = M[..., :2, :2], c = (W/2, H/2)."""
    H, W = dsize
    R = M[..., :2, :2]
    c = torch.tensor([W / 2.0, H / 2.0], dtype=M.dtype, device=M.device)
    t = c - torch.einsum("...ij,j->...i", R, c)
    return torch.cat([R, t[..., None]], dim=-1)


def affine_from_discretized(M, dsize):
    """Full 2x3 warp matrix: center-rotation plus the raw translation
    (reference ``torch_transformation_utils.py:282``)."""
    T = rotation_matrix_about_center(M, dsize)
    return torch.cat([T[..., :2], T[..., 2:] + M[..., 2:]], dim=-1)

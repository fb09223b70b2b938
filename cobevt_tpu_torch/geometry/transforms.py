"""Pose and grid math used by the CorpBEVT forward.

Counterpart of the parts of ``cobevt_tpu/geometry/transforms.py`` the
serving path and the OPV2V dataset use: the host-side numpy poses and grids
are copied as they are, the traced functions take torch tensors and compute
in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def x_to_world(pose) -> np.ndarray:
    """SE(3) matrix taking the ``pose`` frame to the CARLA world frame.

    ``pose`` is the 6-dof CARLA convention ``[x, y, z, roll, yaw, pitch]``
    in meters/degrees (reference ``transformation_utils.py:8``).
    """
    x, y, z, roll, yaw, pitch = (float(v) for v in pose[:6])
    cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    cr, sr = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    cp, sp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))

    m = np.identity(4)
    m[:3, 3] = (x, y, z)
    m[0, 0] = cp * cy
    m[0, 1] = cy * sp * sr - sy * cr
    m[0, 2] = -cy * sp * cr - sy * sr
    m[1, 0] = sy * cp
    m[1, 1] = sy * sp * sr + cy * cr
    m[1, 2] = -sy * sp * cr + cy * sr
    m[2, 0] = sp
    m[2, 1] = -cp * sr
    m[2, 2] = cp * cr
    return m


def x1_to_x2(x1, x2) -> np.ndarray:
    """SE(3) transform from frame ``x1`` to frame ``x2`` (both CARLA poses;
    reference ``transformation_utils.py:52``)."""
    return np.linalg.inv(x_to_world(x2)) @ x_to_world(x1)


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

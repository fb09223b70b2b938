"""Dense 3D voxel backbone (SECOND-style).

Counterpart of ``cobevt_tpu/models/lidar/voxel_backbone.py``
(``VoxelBackBone8x`` of the reference's ``sparse_backbone_3d.py`` built from
dense 3D convolutions): 16-16 / 32 / 64 / 64 channels, an 8x spatial
downsample, and a last (3, 1, 1)-stride-(2, 1, 1) conv to 128 channels,
BatchNorm eps 1e-3 and momentum 0.01.  The JAX package runs these as XLA
convolutions, not Pallas, so here they stay ``nn.Conv3d`` (cuDNN on the
card).  Grids are (B, D, H, W, C) outside and ``channels_last_3d`` NCDHW
views inside, so no copy is made.  Parameter names are the JAX module's
(``conv_input_conv``, ``conv2_subm0_bn``, ...).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.models.lidar.pillar_encoder import BN_EPS, BN_MOMENTUM
from cobevt_tpu_torch.nn.layers import BatchNorm3d


def scatter_voxels_dense(voxel_features, coords, batch_size: int,
                         grid_dhw: Tuple[int, int, int], voxel_mask=None):
    """(N, C) voxel features + (N, 4) [b, z, y, x] coords -> dense
    (B, D, H, W, C) grid.  Masked voxels go to a trash row past the end and
    duplicate coordinates add up."""
    D, H, W = grid_dhw
    C = voxel_features.shape[-1]
    if voxel_mask is None:
        voxel_mask = torch.ones(voxel_features.shape[0], dtype=torch.bool,
                                device=voxel_features.device)
    coords = coords.long()
    flat = (coords[:, 0] * (D * H * W) + coords[:, 1] * (H * W)
            + coords[:, 2] * W + coords[:, 3])
    trash = batch_size * D * H * W
    flat = torch.where(voxel_mask, flat, torch.full_like(flat, trash))
    canvas = voxel_features.new_zeros((trash + 1, C))
    canvas.index_add_(0, flat, voxel_features
                      * voxel_mask[:, None].to(voxel_features.dtype))
    return canvas[:-1].reshape(batch_size, D, H, W, C)


# (prefix, channels, kernel, stride, padding, stride-1 "subm" convs after)
_STAGES = (
    ("conv_input", 16, 3, 1, 1, 0),
    ("conv1", 16, 3, 1, 1, 0),
    ("conv2", 32, 3, 2, 1, 2),
    ("conv3", 64, 3, 2, 1, 2),
    ("conv4", 64, 3, 2, (0, 1, 1), 2),
    ("conv_out", 128, (3, 1, 1), (2, 1, 1), 0, 0),
)


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class DenseVoxelBackbone8x(nn.Module):
    """conv_input -> conv1 -> conv2 (/2) -> conv3 (/2) -> conv4 (/2) ->
    conv_out, each conv followed by BatchNorm and ReLU."""

    def __init__(self, input_channels: int = 4):
        super().__init__()
        c_in = input_channels
        for prefix, ch, k, s, p, n_subm in _STAGES:
            self.add_module(f"{prefix}_conv", nn.Conv3d(
                c_in, ch, k, s, p, bias=False))
            self.add_module(f"{prefix}_bn", BatchNorm3d(
                ch, eps=BN_EPS, momentum=BN_MOMENTUM))
            for i in range(n_subm):
                self.add_module(f"{prefix}_subm{i}_conv", nn.Conv3d(
                    ch, ch, 3, 1, 1, bias=False))
                self.add_module(f"{prefix}_subm{i}_bn", BatchNorm3d(
                    ch, eps=BN_EPS, momentum=BN_MOMENTUM))
            c_in = ch

    @staticmethod
    def output_depth(D: int) -> int:
        """Depth of ``encoded_voxel`` for an input of depth D."""
        for _, _, k, s, p, _ in _STAGES:
            D = (D + 2 * _triple(p)[0] - _triple(k)[0]) // _triple(s)[0] + 1
        return D

    def _unit(self, name, x):
        return F.relu(getattr(self, f"{name}_bn")(
            getattr(self, f"{name}_conv")(x)))

    def forward(self, x):
        """x: (B, D, H, W, C) -> {"encoded_voxel": (B, D', H/8, W/8, 128),
        "multi_scale_3d": {"x_conv1".."x_conv4": (B, d, h, w, c)}}."""
        x = x.permute(0, 4, 1, 2, 3)
        scales = {}
        for prefix, _, _, _, _, n_subm in _STAGES:
            x = self._unit(prefix, x)
            for i in range(n_subm):
                x = self._unit(f"{prefix}_subm{i}", x)
            if prefix[-1].isdigit():
                scales[f"x_{prefix}"] = x.permute(0, 2, 3, 4, 1)
        return {"encoded_voxel": x.permute(0, 2, 3, 4, 1),
                "multi_scale_3d": scales}

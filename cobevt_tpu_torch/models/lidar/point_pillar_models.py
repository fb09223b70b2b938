"""Cooperative LiDAR detection: PointPillars + FuseBEVT (+ max baseline).

Counterpart of ``cobevt_tpu/models/lidar/point_pillar_models.py``: per-agent
PointPillars pillar encoder -> BEV backbone -> shrink conv -> STTF warp into
the ego frame -> FuseBEVT swap-attention fusion (K4 or K6 at eval, see
``models/fusion/swap_fusion.py``) -> anchor-based detection head (cls + 7-dof
regression per anchor).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from cobevt_tpu_torch.geometry.warp import roi_and_agent_mask, sttf_warp
from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder
from cobevt_tpu_torch.models.fusion.zoo import max_fusion
from cobevt_tpu_torch.models.lidar.bev_backbone import (
    BaseBEVBackbone,
    DownsampleConv,
)
from cobevt_tpu_torch.models.lidar.pillar_encoder import (
    PillarVFE,
    pillar_scatter,
)
from cobevt_tpu_torch.nn.layers import conv_nhwc


@dataclasses.dataclass(frozen=True)
class PointPillarConfig:
    max_cav: int = 5
    voxel_size: Tuple[float, float, float] = (0.4, 0.4, 4.0)
    point_cloud_range: Tuple[float, ...] = (-70.4, -40, -3, 70.4, 40, 1)
    max_voxels: int = 8000
    max_points_per_voxel: int = 32
    pillar_filters: Tuple[int, ...] = (64,)
    # backbone
    layer_nums: Tuple[int, ...] = (3, 5, 8)
    layer_strides: Tuple[int, ...] = (2, 2, 2)
    num_filters: Tuple[int, ...] = (64, 128, 256)
    upsample_strides: Tuple[int, ...] = (1, 2, 4)
    num_upsample_filter: Tuple[int, ...] = (128, 128, 128)
    # shrink conv before fusion
    shrink_dim: int = 256
    # fusion
    fusion: str = "swap"           # swap | max
    fusion_window_size: int = 8
    fusion_dim_head: int = 32
    fusion_mlp_dim: int = 512
    fusion_depth: int = 2
    fusion_dropout: float = 0.1
    # sttf at feature stride 2 of the pillar grid
    sttf_downsample_rate: int = 2
    # head
    anchor_num: int = 2

    @property
    def grid_size(self):
        pr = self.point_cloud_range
        return (int(round((pr[3] - pr[0]) / self.voxel_size[0])),
                int(round((pr[4] - pr[1]) / self.voxel_size[1])), 1)


class PointPillarFuseBEVT(nn.Module):
    """Cooperative pillar detector with FuseBEVT fusion."""

    def __init__(self, config: PointPillarConfig = PointPillarConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.fusion not in ("swap", "max"):
            raise ValueError(cfg.fusion)
        self.pillar_vfe = PillarVFE(
            cfg.pillar_filters, True, False, True, cfg.voxel_size,
            cfg.point_cloud_range)
        self.backbone = BaseBEVBackbone(
            cfg.pillar_filters[-1], cfg.layer_nums, cfg.layer_strides,
            cfg.num_filters, cfg.upsample_strides, cfg.num_upsample_filter)
        backbone_out = sum(cfg.num_upsample_filter) \
            if cfg.upsample_strides else cfg.num_filters[-1]
        self.shrink_conv = DownsampleConv(backbone_out, (cfg.shrink_dim,),
                                          (1,), (1,))
        if cfg.fusion == "swap":
            self.fusion_net = SwapFusionEncoder(
                input_dim=cfg.shrink_dim, mlp_dim=cfg.fusion_mlp_dim,
                agent_size=cfg.max_cav, window_size=cfg.fusion_window_size,
                dim_head=cfg.fusion_dim_head, dropout=cfg.fusion_dropout,
                depth=cfg.fusion_depth, mask=True)
        self.cls_head = nn.Conv2d(cfg.shrink_dim, cfg.anchor_num, 1)
        self.reg_head = nn.Conv2d(cfg.shrink_dim, 7 * cfg.anchor_num, 1)

    def forward(self, batch, generator=None):
        """batch:
             voxel_features: (B, L, N, P, 4); voxel_num_points: (B, L, N)
             voxel_coords: (B, L, N, 4) [0, z, y, x] per-agent grids
             voxel_mask: (B, L, N) valid-voxel mask
             transformation_matrix: (B, L, 4, 4); agent_mask: (B, L)
        Returns {cls_preds (B, h, w, anchor_num),
                 reg_preds (B, h, w, anchor_num*7)}.

        Training takes batch statistics in every BatchNorm and the fusion's
        output dropouts; those draw from the device's global generator
        (``torch.manual_seed``), so ``generator``, the train step's explicit
        one, is accepted and not read."""
        cfg = self.config
        vf = batch["voxel_features"]
        B, L, N, P, _ = vf.shape

        coords = batch["voxel_coords"].reshape(B * L * N, 4)
        pillars = self.pillar_vfe(
            vf.reshape(B * L * N, P, 4),
            batch["voxel_num_points"].reshape(B * L * N), coords)

        # one canvas per (batch, agent): the combined index as batch index
        agent_idx = torch.arange(B * L, device=vf.device).repeat_interleave(N)
        coords = torch.cat([agent_idx[:, None].to(coords.dtype),
                            coords[:, 1:]], dim=1)
        canvas = pillar_scatter(
            pillars, coords, B * L, cfg.grid_size,
            batch["voxel_mask"].reshape(B * L * N) > 0)    # (B*L, ny, nx, C)

        feats = self.shrink_conv(self.backbone(canvas))
        h, w = feats.shape[1:3]
        x = feats.reshape(B, L, h, w, -1)
        agent_mask = batch["agent_mask"]
        x = x * agent_mask[:, :, None, None, None].to(x.dtype)

        tmat = batch["transformation_matrix"]
        x = sttf_warp(x, tmat, cfg.voxel_size[0], cfg.sttf_downsample_rate)
        com_mask = roi_and_agent_mask((B, L, h, w), agent_mask, tmat,
                                      cfg.voxel_size[0],
                                      cfg.sttf_downsample_rate)
        if cfg.fusion == "swap":
            fused = self.fusion_net(x, com_mask, generator=generator)
        else:
            fused = max_fusion(x)
        return {"cls_preds": conv_nhwc(self.cls_head, fused),
                "reg_preds": conv_nhwc(self.reg_head, fused)}

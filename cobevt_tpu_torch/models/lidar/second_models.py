"""SECOND-style cooperative voxel detector, built from a hypes dict.

Counterpart of ``cobevt_tpu/models/lidar/second_models.py``: mean-VFE ->
dense voxel scatter -> :class:`DenseVoxelBackbone8x` -> height compression
-> :class:`BaseBEVBackbone` -> [STTF warp into the ego frame + max or
FuseBEVT fusion] -> anchor heads.  The geometry comes from the
``load_second_params`` hypes parser (``configs/hypes.py``).  FuseBEVT takes
K6 at eval where its gate holds (the full SECOND map, (B, L, 100, 176,
512), is beyond K4's resident budget) and the stock modules over K1 + K5 in
training.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from cobevt_tpu_torch.geometry.warp import roi_and_agent_mask, sttf_warp
from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder
from cobevt_tpu_torch.models.fusion.zoo import max_fusion
from cobevt_tpu_torch.models.lidar.bev_backbone import BaseBEVBackbone
from cobevt_tpu_torch.models.lidar.misc import height_compression, mean_vfe
from cobevt_tpu_torch.models.lidar.voxel_backbone import (
    DenseVoxelBackbone8x,
    scatter_voxels_dense,
)
from cobevt_tpu_torch.nn.layers import conv_nhwc

FUSIONS = ("none", "max", "swap")


@dataclasses.dataclass(frozen=True)
class SecondConfig:
    max_cav: int = 1
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    point_cloud_range: Tuple[float, ...] = (-70.4, -40, -3, 70.4, 40, 1)
    # (W, H, D) in voxels, normally injected by load_second_params
    grid_size: Tuple[int, int, int] = (1408, 800, 40)
    num_point_features: int = 4
    # BEV backbone (SECOND defaults)
    layer_nums: Tuple[int, ...] = (5, 5)
    layer_strides: Tuple[int, ...] = (1, 2)
    num_filters: Tuple[int, ...] = (128, 256)
    upsample_strides: Tuple[int, ...] = (1, 2)
    num_upsample_filter: Tuple[int, ...] = (256, 256)
    # fusion: none | max | swap
    fusion: str = "none"
    fusion_window_size: int = 4
    fusion_dim_head: int = 32
    fusion_mlp_dim: int = 256
    fusion_depth: int = 1
    fusion_dropout: float = 0.0
    anchor_num: int = 2

    @property
    def grid_dhw(self):
        W, H, D = self.grid_size
        return (D, H, W)

    @property
    def bev_channels(self) -> int:
        """Channels of the backbone's output, the fused map's width."""
        return (sum(self.num_upsample_filter) if self.upsample_strides
                else self.num_filters[-1])


class SecondDetector(nn.Module):
    """mean-VFE -> dense voxel scatter -> VoxelBackbone8x -> height
    compression -> BEV backbone -> [STTF + fusion] -> anchor heads."""

    def __init__(self, config: SecondConfig = SecondConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.fusion not in FUSIONS:
            raise ValueError(f"fusion {cfg.fusion!r} not in {FUSIONS}")
        self.backbone_3d = DenseVoxelBackbone8x(cfg.num_point_features)
        depth = DenseVoxelBackbone8x.output_depth(cfg.grid_dhw[0])
        self.backbone_2d = BaseBEVBackbone(
            128 * depth, cfg.layer_nums, cfg.layer_strides, cfg.num_filters,
            cfg.upsample_strides, cfg.num_upsample_filter)
        C = cfg.bev_channels
        if cfg.fusion == "swap" and cfg.max_cav > 1:
            self.fusion_net = SwapFusionEncoder(
                input_dim=C, mlp_dim=cfg.fusion_mlp_dim,
                agent_size=cfg.max_cav, window_size=cfg.fusion_window_size,
                dim_head=cfg.fusion_dim_head, dropout=cfg.fusion_dropout,
                depth=cfg.fusion_depth, mask=True)
        self.cls_head = nn.Conv2d(C, cfg.anchor_num, 1)
        self.reg_head = nn.Conv2d(C, 7 * cfg.anchor_num, 1)

    def forward(self, batch, generator=None):
        """batch:
             voxel_features: (B, L, N, P, 4); voxel_num_points: (B, L, N)
             voxel_coords: (B, L, N, 4) [0, z, y, x]
             voxel_mask: (B, L, N)
             transformation_matrix: (B, L, 4, 4); agent_mask: (B, L)
        Returns {cls_preds, reg_preds} on the fused (ego) BEV grid.

        ``generator`` (the train step's) is accepted and not read: the
        fusion's dropouts draw from the device's global generator, as in
        ``PointPillarFuseBEVT``."""
        cfg = self.config
        vf = batch["voxel_features"]
        B, L, N, P, _ = vf.shape

        # the per-voxel means in the input's dtype, then in the convs'
        feats = mean_vfe(vf.reshape(B * L * N, P, -1),
                         batch["voxel_num_points"].reshape(B * L * N))
        feats = feats.to(self.cls_head.weight.dtype)
        # one grid per (batch, agent): the agent index as the batch index
        agent_idx = torch.arange(B * L, device=vf.device).repeat_interleave(N)
        coords = batch["voxel_coords"].reshape(B * L * N, 4)
        coords = torch.cat([agent_idx[:, None].to(coords.dtype),
                            coords[:, 1:]], dim=1)
        grid = scatter_voxels_dense(
            feats, coords, B * L, cfg.grid_dhw,
            batch["voxel_mask"].reshape(B * L * N) > 0)

        out3d = self.backbone_3d(grid)
        bev = height_compression(out3d["encoded_voxel"])
        feats2d = self.backbone_2d(bev)
        h, w = feats2d.shape[1:3]
        x = feats2d.reshape(B, L, h, w, -1)

        if cfg.fusion != "none" and L > 1:
            agent_mask = batch["agent_mask"]
            x = x * agent_mask[:, :, None, None, None].to(x.dtype)
            tmat = batch["transformation_matrix"]
            # BEV cell size after the 8x voxel stride and the backbone's
            res = cfg.voxel_size[0]
            rate = 8 * cfg.layer_strides[0]
            x = sttf_warp(x, tmat, res, rate)
            com_mask = roi_and_agent_mask((B, L, h, w), agent_mask, tmat,
                                          res, rate)
            if cfg.fusion == "swap":
                fused = self.fusion_net(x, com_mask, generator=generator)
            else:
                fused = max_fusion(x)
        else:
            fused = x[:, 0]
        return {"cls_preds": conv_nhwc(self.cls_head, fused),
                "reg_preds": conv_nhwc(self.reg_head, fused)}


def second_config_from_hypes(hypes: dict) -> SecondConfig:
    """Map a SECOND hypes dict (``yaml_parser: load_second_params``, which
    injects ``model.args.grid_size``) onto :class:`SecondConfig`."""
    args = hypes["model"]["args"]
    pre = hypes["preprocess"]
    bb = args.get("base_bev_backbone", {})
    fusion = args.get("fusion", {})
    return SecondConfig(
        max_cav=hypes.get("train_params", {}).get("max_cav", 1),
        voxel_size=tuple(pre["args"]["voxel_size"]),
        point_cloud_range=tuple(pre["cav_lidar_range"]),
        grid_size=tuple(int(g) for g in args["grid_size"]),
        num_point_features=args.get("mean_vfe", {}).get(
            "num_point_features", 4),
        layer_nums=tuple(bb.get("layer_nums", (5, 5))),
        layer_strides=tuple(bb.get("layer_strides", (1, 2))),
        num_filters=tuple(bb.get("num_filters", (128, 256))),
        upsample_strides=tuple(bb.get("upsample_strides", (1, 2))),
        num_upsample_filter=tuple(bb.get("num_upsample_filter",
                                         (256, 256))),
        fusion=fusion.get("core_method", "none"),
        fusion_window_size=fusion.get("window_size", 4),
        fusion_dim_head=fusion.get("dim_head", 32),
        fusion_mlp_dim=fusion.get("mlp_dim", 256),
        fusion_depth=fusion.get("depth", 1),
        fusion_dropout=fusion.get("drop_out", 0.0),
        anchor_num=hypes.get("postprocess", {}).get(
            "anchor_args", {}).get("num", 2))

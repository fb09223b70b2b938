"""CorpBEVT: the cooperative CoBEVT graph (per-agent encoder + FAX, ego
warp, FuseBEVT, decoder, seg head).

Counterpart of ``cobevt_tpu/models/corpbevt.py:CorpBEVT`` (reference
``opv2v/opencood/models/corpbevt.py:67``).  The batch arrives padded to
``max_cav`` with a (B, L) agent mask, in the JAX package's layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from cobevt_tpu_torch.geometry.warp import roi_and_agent_mask, sttf_warp
from cobevt_tpu_torch.models.fax import FAXConfig, FAXModule
from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder
from cobevt_tpu_torch.models.heads import (
    BevSegHead,
    NaiveCompressor,
    NaiveDecoder,
)
from cobevt_tpu_torch.nn.layers import images_from_uint8
from cobevt_tpu_torch.nn.resnet import ResNetEncoder


@dataclasses.dataclass(frozen=True)
class CorpBEVTConfig:
    """The ``model.args`` block of ``opcamera/corpbevt.yaml``."""

    max_cav: int = 5
    target: str = "dynamic"
    # encoder
    encoder_num_layers: int = 34
    encoder_id_pick: Tuple[int, ...] = (1, 2, 3)
    # rematerialise the trunk blocks in the backward pass (training only)
    encoder_remat: bool = False
    image_height: int = 512
    image_width: int = 512
    # fax (backbone_output_shape auto-derived if empty)
    fax: FAXConfig = FAXConfig()
    # compression (0 = off)
    compression: int = 0
    # sttf
    sttf_resolution: float = 0.390625
    sttf_downsample_rate: int = 8
    use_roi_mask: bool = True
    # fusion
    fusion_mlp_dim: int = 256
    fusion_window_size: int = 8
    fusion_dim_head: int = 32
    fusion_dropout: float = 0.1
    fusion_depth: int = 3
    fusion_mask: bool = True
    fusion_mean_over_valid: bool = False
    # decoder / head
    decoder_num_layer: int = 3
    decoder_num_ch: Tuple[int, ...] = (32, 64, 128)
    seg_head_dim: int = 32
    output_class: int = 2

    def resolved_fax(self) -> FAXConfig:
        if self.fax.backbone_output_shape:
            return self.fax
        shapes = ResNetEncoder.output_shapes(
            self.encoder_num_layers, self.encoder_id_pick,
            (self.image_height, self.image_width))
        return dataclasses.replace(
            self.fax,
            backbone_output_shape=tuple(shapes),
            image_height=self.image_height,
            image_width=self.image_width)


class CorpBEVT(nn.Module):
    """encoder -> FAX -> (compressor) -> STTF ego warp -> ROI+agent mask ->
    FuseBEVT -> decoder -> seg head.  Runs in the dtype of its parameters
    (``model.to(torch.bfloat16)`` for bf16 serving); geometry stays f32."""

    def __init__(self, config: CorpBEVTConfig = CorpBEVTConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        fax = cfg.resolved_fax()
        dim = fax.dim[-1]
        self.encoder = ResNetEncoder(cfg.encoder_num_layers,
                                     cfg.encoder_id_pick,
                                     remat=cfg.encoder_remat)
        self.fax = FAXModule(fax)
        if cfg.compression > 0:
            self.naive_compressor = NaiveCompressor(dim, cfg.compression)
        self.fusion_net = SwapFusionEncoder(
            input_dim=dim, mlp_dim=cfg.fusion_mlp_dim,
            agent_size=cfg.max_cav, window_size=cfg.fusion_window_size,
            dim_head=cfg.fusion_dim_head, dropout=cfg.fusion_dropout,
            depth=cfg.fusion_depth, mask=cfg.fusion_mask,
            mean_over_valid=cfg.fusion_mean_over_valid)
        self.decoder = NaiveDecoder(dim, cfg.decoder_num_layer,
                                    cfg.decoder_num_ch)
        self.seg_head = BevSegHead(cfg.target, cfg.seg_head_dim,
                                   cfg.output_class)

    def forward(self, batch, stage: str = "full", agent_bev=None,
                generator=None):
        """batch: dict of tensors on the model's device
             inputs: (B, L, M, H, W, 3) uint8 or float images (padded to
                     max_cav)
             intrinsic: (B, L, M, 3, 3)
             extrinsic: (B, L, M, 4, 4)
             transformation_matrix: (B, L, 4, 4) agent->ego SE(3)
             agent_mask: (B, L) 1.0 for live agents
        Returns a dict of (B, 1, H, W, classes) seg logits.

        ``stage`` splits the graph at the per-agent/cooperative boundary:
          "full"   -- the whole graph;
          "encode" -- encoder -> FAX -> compressor on the agents present;
                      returns the (B, L, H, W, C) agent BEV maps;
          "fuse"   -- warp -> mask -> fusion -> decoder -> head on
                      ``agent_bev`` padded back to max_cav (only
                      ``transformation_matrix`` and ``agent_mask`` are
                      read from ``batch``).

        ``generator`` draws the attention-dropout mask of a training
        forward (the JAX package's ``rngs={"dropout": key}``); None takes
        the device's global generator.
        """
        cfg = self.config
        dtype = self.encoder.encoder.conv1.weight.dtype
        if stage in ("full", "encode"):
            x = images_from_uint8(batch["inputs"]).to(dtype)
            feats = self.encoder(x)
            x = self.fax(feats, batch["intrinsic"], batch["extrinsic"],
                         generator=generator)
            if cfg.compression > 0:
                Bc, Lc, H, W, C = x.shape
                x = self.naive_compressor(
                    x.reshape(Bc * Lc, H, W, C)).reshape(Bc, Lc, H, W, C)
            if stage == "encode":
                return x
        elif stage == "fuse" and agent_bev is not None:
            x = agent_bev
        else:
            raise ValueError(f"stage={stage!r} needs stage 'full', 'encode' "
                             "or 'fuse' with agent_bev")
        B, L = x.shape[:2]

        tmat = batch["transformation_matrix"]
        agent_mask = batch["agent_mask"]
        # zero padded agents so the padded layout equals the reference's
        # regroup() zero-padding
        x = x * agent_mask[:, :, None, None, None].to(x.dtype)
        x = sttf_warp(x, tmat, cfg.sttf_resolution, cfg.sttf_downsample_rate)
        H, W = x.shape[2:4]
        if cfg.use_roi_mask:
            com_mask = roi_and_agent_mask((B, L, H, W), agent_mask, tmat,
                                          cfg.sttf_resolution,
                                          cfg.sttf_downsample_rate)
        else:
            com_mask = agent_mask[:, :, None, None].float().expand(
                B, L, H, W)
        fused = self.fusion_net(x, com_mask, agent_mask=agent_mask)
        return self.seg_head(self.decoder(fused[:, None]))

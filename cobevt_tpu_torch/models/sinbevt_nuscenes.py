"""SinBEVT on nuScenes: PyramidAxialEncoder + residual Decoder + CVT head.

Counterpart of ``cobevt_tpu/models/sinbevt_nuscenes.py`` (reference
``nuscenes/cross_view_transformer/model/encoder_pyramid_axial.py:475``,
``decoder.py:39``, ``cvt.py:4``): the FAX design of OPV2V with the
nuScenes differences -- ImageNet input normalization, an EfficientNet
trunk, an optional feature down-scale, a pixel-unshuffle narrow factor of
``dim // 2`` (OPV2V's FAX uses ``// 4``), no final self-attention, and the
extrinsics inverted inside the encoder.  The stages are the port's
``models/fax.py:FAXStages``, OPV2V's FAX stack at narrow factor 2, so the
cross-view branches take K2 at eval where ``fused_xattn_ok`` holds and K1
on the stock modules (``COBEVT_FUSED_XATTN=0``).  Channels-last; attribute
paths mirror the flax names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.models.cvt_nuscenes import CVTNuScenesEncoder
from cobevt_tpu_torch.models.fax import FAXStages
from cobevt_tpu_torch.nn.efficientnet import EfficientNetExtractor
from cobevt_tpu_torch.nn.layers import (
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    images_from_uint8,
    normalize_image,
    torch_conv,
)


@dataclasses.dataclass(frozen=True)
class PyramidAxialConfig:
    """``nuscenes/config/model/cvt_pyramid_axial.yaml`` (a copy of the JAX
    package's config).  At 224 x 480 and BEV 200 the padded feature grids
    (60, 120) / (6, 12), (30, 60) / (6, 12) and (14, 30) / (14, 30) give
    100, 25 and 1 windows, matching the 10 x 10, 5 x 5 and 1 x 1 BEV query
    windows of the three stages."""

    dim: Tuple[int, ...] = (32, 64, 128)
    middle: Tuple[int, ...] = (2, 2, 2)
    scale: float = 1.0
    image_height: int = 224
    image_width: int = 480
    backbone_model: str = "efficientnet-b4"
    backbone_layers: Tuple[str, ...] = ("reduction_2", "reduction_3",
                                        "reduction_4")
    qkv_bias: bool = True
    heads: Tuple[int, ...] = (1, 2, 4)
    dim_head: Tuple[int, ...] = (32, 32, 32)
    q_win_size: Tuple[Tuple[int, int], ...] = ((10, 10), (10, 10), (25, 25))
    feat_win_size: Tuple[Tuple[int, int], ...] = ((6, 12), (6, 12),
                                                  (14, 30))
    bev_embedding_flag: Tuple[bool, ...] = (True, False, False)
    no_image_features: bool = False
    skip: bool = True
    sigma: float = 1.0
    bev_height: int = 200
    bev_width: int = 200
    h_meters: float = 100.0
    w_meters: float = 100.0
    offset: float = 0.0
    upsample_scales: Tuple[int, ...] = (2, 4, 8)
    remat_backbone: bool = True

    def feature_shapes(self):
        """(h, w, c) of each backbone map after the down-scale."""
        shapes = EfficientNetExtractor.output_shapes(
            self.backbone_layers, (self.image_height, self.image_width),
            self.backbone_model)
        return [(int(h * self.scale), int(w * self.scale), c)
                if self.scale < 1.0 else (h, w, c) for h, w, c in shapes]


def downscale_features(f, scale: float):
    """``jax.image.resize(f, ..., "bilinear")`` to ``int(size * scale)``:
    a shrink, which JAX antialiases (a triangle filter widened by the
    factor), as ``F.interpolate(..., antialias=True)`` does."""
    N, h, w, c = f.shape
    out = F.interpolate(f.permute(0, 3, 1, 2),
                        size=(int(h * scale), int(w * scale)),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class PyramidAxialEncoder(FAXStages):
    """Normalize -> EfficientNet pyramid -> 3 FAX stages (no final
    self-attention)."""

    def __init__(self, config: PyramidAxialConfig = PyramidAxialConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.backbone = EfficientNetExtractor(
            cfg.backbone_layers, cfg.backbone_model, remat=cfg.remat_backbone)
        # narrow factor 2: dim[i] // 2 * 4 == dim[i + 1] when the width
        # doubles
        self._build_stages(cfg, cfg.feature_shapes(), narrow=2)

    def forward(self, batch, features=None, generator=None):
        """batch: image (B, n, H, W, 3) in [0, 1] (or uint8); intrinsics
        (B, n, 3, 3); extrinsics (B, n, 4, 4).  Returns (B, H', W',
        dim[-1]) in the dtype of the model's parameters.  ``features``
        (list of (B*n, h, w, c)) bypasses the backbone; ``generator`` draws
        the trunk's drop-connect gates in training."""
        cfg = self.config
        dtype = self.bev_embedding.learned_features.dtype
        image = images_from_uint8(batch["image"], normalize=False)
        B, n, H, W, _ = image.shape
        # inverted in f32, without the host sync of torch.linalg.inv's check
        I_inv = torch.linalg.inv_ex(batch["intrinsics"].float())[0]
        E_inv = torch.linalg.inv_ex(batch["extrinsics"].float())[0]
        if features is not None:
            feats = list(features)
        else:
            flat = normalize_image(image.reshape(B * n, H, W, 3).float())
            feats = self.backbone(flat.to(dtype), generator=generator)
        if cfg.scale < 1.0:
            feats = [downscale_features(f, cfg.scale) for f in feats]

        return self._run_stages(
            [f.reshape(B, n, *f.shape[1:]) for f in feats], I_inv, E_inv,
            dtype)


def upsample_bilinear_2x_align_corners(x):
    """``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)``
    on NHWC."""
    out = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)


def resize_nearest(x, hw):
    """Nearest resize of NHWC ``x`` to ``hw`` with the JAX package's index
    math ``arange(Ho) * H // Ho`` (``F.interpolate(mode="nearest")`` rounds
    otherwise at non-integer ratios)."""
    _, H, W, _ = x.shape
    Ho, Wo = hw
    iy = torch.arange(Ho, device=x.device) * H // Ho
    ix = torch.arange(Wo, device=x.device) * W // Wo
    return x[:, iy][:, :, ix]


class DecoderBlock(nn.Module):
    """bilinear x2 -> conv-BN-ReLU -> conv-BN (+ a residual 1x1 conv of the
    encoder output, nearest-resized) -> ReLU.  torch paths ``conv.<j>``
    (0 the upsample, 3 the ReLU) and ``up``."""

    def __init__(self, in_channels: int, out_channels: int, skip_dim: int,
                 residual: bool = True, factor: int = 2):
        super().__init__()
        dim = out_channels // factor
        self.conv = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            torch_conv(in_channels, dim, 3, 1, 1, False), batch_norm(dim),
            nn.ReLU(), torch_conv(dim, out_channels, 1, 1, 0, False),
            batch_norm(out_channels))
        self.up = (torch_conv(skip_dim, out_channels, 1, 1, 0, True)
                   if residual else None)

    def forward(self, x, skip):
        c = self.conv
        x = upsample_bilinear_2x_align_corners(x)
        x = F.relu(bn_nhwc(c[2], conv_nhwc(c[1], x)))
        x = bn_nhwc(c[5], conv_nhwc(c[4], x))
        if self.up is not None:
            x = x + resize_nearest(conv_nhwc(self.up, skip), x.shape[1:3])
        return F.relu(x)


class Decoder(nn.Module):
    """Chain of DecoderBlocks, each skipping back to the encoder output."""

    def __init__(self, dim: int, blocks: Tuple[int, ...] = (128, 128, 64),
                 residual: bool = True, factor: int = 2):
        super().__init__()
        layers, in_ch = [], dim
        for out_ch in blocks:
            layers.append(DecoderBlock(in_ch, out_ch, dim, residual, factor))
            in_ch = out_ch
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        y = x
        for layer in self.layers:
            y = layer(y, x)
        return y


class CrossViewTransformer(nn.Module):
    """encoder -> decoder -> to_logits, sliced into named NHWC outputs.
    The config's type picks the encoder, as the reference's Hydra model
    switch does (``config/model/{cvt_pyramid_axial,cvt}.yaml``): a
    ``PyramidAxialConfig`` builds the FAX pyramid, a ``CVTNuScenesConfig``
    (``models/cvt_nuscenes.py``) the dense CVT baseline."""

    def __init__(self, encoder_config=PyramidAxialConfig(),
                 decoder_blocks: Tuple[int, ...] = (128, 128, 64),
                 dim_last: int = 64,
                 outputs: Tuple[Tuple[str, Tuple[int, int]], ...] = (
                     ("bev", (0, 1)),)):
        super().__init__()
        self.outputs = tuple(outputs)
        if isinstance(encoder_config, PyramidAxialConfig):
            self.encoder = PyramidAxialEncoder(encoder_config)
            dim = encoder_config.dim[-1]
        else:
            self.encoder = CVTNuScenesEncoder(encoder_config)
            dim = encoder_config.dim
        self.decoder = Decoder(dim, tuple(decoder_blocks))
        dim_max = max(stop for _, (_, stop) in self.outputs)
        self.to_logits = nn.Sequential(
            torch_conv(decoder_blocks[-1], dim_last, 3, 1, 1, False),
            batch_norm(dim_last), nn.ReLU(),
            torch_conv(dim_last, dim_max, 1, 1, 0, True))

    def forward(self, batch, generator=None):
        """batch as :meth:`PyramidAxialEncoder.forward`; returns
        {name: (B, H, W, stop - start)} logits."""
        y = self.decoder(self.encoder(batch, generator=generator))
        t = self.to_logits
        z = F.relu(bn_nhwc(t[1], conv_nhwc(t[0], y)))
        z = conv_nhwc(t[3], z)
        return {k: z[..., start:stop] for k, (start, stop) in self.outputs}

"""Single-scale and FPN-concat ResNet encoder variants.

Counterpart of ``cobevt_tpu/nn/resnet_variants.py`` (reference
``resnet_encoder.py:8``, one pyramid stage, and
``resnet_encoder_concat.py:12``, layers 2-4 through an optional
torchvision-style FPN, nearest-upsampled to layer2's stride, concatenated
and fused by a 1 x 1 conv).  Both are built over :class:`ResNetTrunk`, so at
eval the stride-1 BasicBlocks with >= 128 channels take K3 as in every
other trunk.  NHWC in and out; (B, L, M) fold into one batch axis.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cobevt_tpu_torch.nn.layers import conv_nhwc
from cobevt_tpu_torch.nn.resnet import _SPECS, _WIDTHS, ResNetTrunk


def _up_nearest(x, n: int):
    """Nearest upsampling of an NHWC map by repeating each pixel n x n."""
    return x.repeat_interleave(n, dim=1).repeat_interleave(n, dim=2)


def _stage_channels(num_layers: int):
    block, _ = _SPECS[num_layers]
    expansion = 1 if block == "basic" else 4
    return [w * expansion for w in _WIDTHS]


class FeaturePyramidNetwork(nn.Module):
    """torchvision-style FPN: 1 x 1 lateral convs, a top-down nearest x2
    path, 3 x 3 output convs."""

    def __init__(self, in_channels, out_channels: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Conv2d(c, out_channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [nn.Conv2d(out_channels, out_channels, 3, 1, 1)
             for _ in in_channels])

    def forward(self, feats):
        """feats: NHWC maps, each half the size of the one before."""
        laterals = [conv_nhwc(conv, f)
                    for conv, f in zip(self.inner_blocks, feats)]
        outs = [None] * len(feats)
        last = outs[-1] = laterals[-1]
        for i in range(len(feats) - 2, -1, -1):
            last = outs[i] = laterals[i] + _up_nearest(last, 2)
        return [conv_nhwc(conv, o) for conv, o in zip(self.layer_blocks, outs)]


class ResNetEncoderSingle(nn.Module):
    """One selected pyramid stage over multi-agent cameras: (B, L, M, H, W,
    3) -> (B, L, M, h, w, C) of stage ``id_pick``."""

    def __init__(self, num_layers: int = 34, id_pick: int = 1):
        super().__init__()
        self.id_pick = id_pick
        self.encoder = ResNetTrunk(num_layers)

    def forward(self, images):
        B, L, M, H, W, C = images.shape
        f = self.encoder(images.reshape(B * L * M, H, W, C))[self.id_pick]
        return f.reshape(B, L, M, *f.shape[1:])


class ResNetEncoderConcat(nn.Module):
    """Layers 2-4 (FPN-refined when ``fpn_out_dim`` > 0), upsampled to
    layer2's stride, concatenated and fused by a 1 x 1 conv."""

    def __init__(self, num_layers: int = 34, fpn_out_dim: int = 0,
                 conv_output_dim: int = 128):
        super().__init__()
        self.encoder = ResNetTrunk(num_layers)
        widths = _stage_channels(num_layers)[1:]
        if fpn_out_dim > 0:
            self.fpn_network = FeaturePyramidNetwork(widths, fpn_out_dim)
            widths = [fpn_out_dim] * 3
        self.fpn_out_dim = fpn_out_dim
        self.conv2d = nn.Conv2d(sum(widths), conv_output_dim, 1)

    def forward(self, images):
        B, L, M, H, W, C = images.shape
        outs = self.encoder(images.reshape(B * L * M, H, W, C))
        x1, x2, x3 = outs[1:]
        if self.fpn_out_dim > 0:
            x1, x2, x3 = self.fpn_network([x1, x2, x3])
        cat = torch.cat([x1, _up_nearest(x2, 2), _up_nearest(x3, 4)], dim=-1)
        fused = conv_nhwc(self.conv2d, cat)
        return fused.reshape(B, L, M, *fused.shape[1:])

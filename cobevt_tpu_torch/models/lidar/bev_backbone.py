"""BEV conv backbones for the LiDAR track.

Counterpart of ``cobevt_tpu/models/lidar/bev_backbone.py``
(``BaseBEVBackbone``: SECOND-style conv pyramid + transposed-conv upsample
and concat, reference ``base_bev_backbone.py``; ``AutoEncoder``, reference
``auto_encoder.py``; ``AttBEVBackbone``, the same pyramid with per-pixel
attention fusion of the agents at every scale, reference
``att_bev_backbone.py``; ``DownsampleConv``, reference
``downsample_conv.py``).  BatchNorm uses OpenPCDet's eps 1e-3 and
momentum 0.01.  Module paths are the reference's (``blocks.<i>.<j>``,
``deblocks.<i>.<j>``, ``layers.<i>.<j>``), with ``nn.Identity`` where the
reference has a parameter-free ZeroPad2d; activations are NHWC outside and
``channels_last`` NCHW views inside, so no copy is made.  The convolutions
stay ``F.conv2d`` / ``F.conv_transpose2d``: the JAX package runs them as
plain ``torch_conv`` too, not through its fused 3x3 kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.models.fusion.zoo import AttFusion
from cobevt_tpu_torch.nn.layers import batch_norm
from cobevt_tpu_torch.models.lidar.pillar_encoder import BN_EPS, BN_MOMENTUM


def _conv_bn_relu(c_in, c_out, kernel, stride, padding):
    return [nn.Conv2d(c_in, c_out, kernel, stride, padding, bias=False),
            batch_norm(c_out, BN_EPS, BN_MOMENTUM), nn.ReLU()]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _down_blocks(in_channels, layer_nums, layer_strides, num_filters):
    """Each level's strided conv and its stride-1 convs, reference indices:
    0 ZeroPad2d, 1 conv (stride), 2 bn, 3 relu, then n x (conv 4+3k,
    bn 5+3k, relu)."""
    c_in = [in_channels] + list(num_filters[:-1])
    blocks = nn.ModuleList()
    for i, n in enumerate(layer_nums):
        mods = [nn.Identity()] + _conv_bn_relu(
            c_in[i], num_filters[i], 3, layer_strides[i], 1)
        for _ in range(n):
            mods += _conv_bn_relu(num_filters[i], num_filters[i], 3, 1, 1)
        blocks.append(nn.Sequential(*mods))
    return blocks


def _deconv_bn_relu(c_in, c_out, stride):
    return nn.Sequential(
        nn.ConvTranspose2d(c_in, c_out, stride, stride, bias=False),
        batch_norm(c_out, BN_EPS, BN_MOMENTUM), nn.ReLU())


class BaseBEVBackbone(nn.Module):
    """Downsampling conv blocks + per-level upsampling deconvs, concat."""

    def __init__(self, in_channels: int,
                 layer_nums: Sequence[int] = (3, 5, 8),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (64, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filter: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.blocks = _down_blocks(in_channels, layer_nums, layer_strides,
                                   num_filters)
        self.deblocks = nn.ModuleList()
        for i in range(len(layer_nums) if upsample_strides else 0):
            s = upsample_strides[i]
            if s >= 1:
                self.deblocks.append(_deconv_bn_relu(
                    num_filters[i], num_upsample_filter[i], s))
            else:
                ds = int(round(1 / s))
                self.deblocks.append(nn.Sequential(
                    nn.Conv2d(num_filters[i], num_upsample_filter[i], ds,
                              ds, bias=False),
                    batch_norm(num_upsample_filter[i], BN_EPS, BN_MOMENTUM),
                    nn.ReLU()))

    def forward(self, x, return_multiscale: bool = False):
        """x: (B, H, W, C) -> the concat of the upsampled levels
        (B, H/first_stride, W/first_stride, sum(num_upsample_filter))."""
        x = _nchw(x)
        ups, levels = [], []
        for i, block in enumerate(self.blocks):
            x = block(x)
            levels.append(_nhwc(x))
            ups.append(self.deblocks[i](x) if len(self.deblocks) else x)
        out = _nhwc(torch.cat(ups, dim=1) if len(ups) > 1 else ups[0])
        if return_multiscale:
            return out, levels
        return out


def _up_nearest(x, n: int):
    """Nearest upsampling of an NCHW map by repeating each pixel n x n."""
    return x.repeat_interleave(n, dim=2).repeat_interleave(n, dim=3)


class AutoEncoder(nn.Module):
    """Conv down/up autoencoder that compresses a feature map: stride-2
    convs halving the channels, then x2 nearest upsampling + conv back."""

    def __init__(self, channels: int, compress_layers: int = 1):
        super().__init__()
        C = channels
        self.encoder = nn.ModuleList([
            nn.Conv2d(C // 2 ** i, C // 2 ** (i + 1), 3, 2, 1)
            for i in range(compress_layers)])
        self.decoder = nn.ModuleList([
            nn.Conv2d(C // 2 ** (compress_layers - i),
                      C // 2 ** (compress_layers - i - 1), 3, 1, 1)
            for i in range(compress_layers)])

    def forward(self, x):
        """x: (N, H, W, C) NHWC."""
        x = _nchw(x)
        for conv in self.encoder:
            x = F.relu(conv(x))
        for conv in self.decoder:
            x = F.relu(conv(_up_nearest(x, 2)))
        return _nhwc(x)


class AttBEVBackbone(nn.Module):
    """BEV backbone that fuses the agents by per-pixel attention
    (:class:`AttFusion`, the ego row) at every scale before the scale's
    deconv.  Works on the padded (B, L, H, W, C) layout; ``agent_mask``
    keeps padded agents out of every fusion."""

    def __init__(self, in_channels: int,
                 layer_nums: Sequence[int] = (3, 5, 8),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (64, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filter: Sequence[int] = (128, 128, 128),
                 compression: int = 0):
        super().__init__()
        self.compression = compression
        self.blocks = _down_blocks(in_channels, layer_nums, layer_strides,
                                   num_filters)
        if compression > 0:
            self.compression_modules = nn.ModuleList([
                AutoEncoder(f, compression) for f in num_filters])
        self.fuse_modules = nn.ModuleList([AttFusion(f)
                                           for f in num_filters])
        self.deblocks = nn.ModuleList([
            _deconv_bn_relu(f, u, s) for f, u, s in
            zip(num_filters, num_upsample_filter, upsample_strides)])

    def forward(self, x, agent_mask):
        """x: (B, L, H, W, C); agent_mask: (B, L) -> (B, h, w, C_out)."""
        B, L = x.shape[:2]
        flat = _nchw(x.reshape(B * L, *x.shape[2:]))
        ups = []
        for i, block in enumerate(self.blocks):
            flat = block(flat)
            if self.compression > 0:
                flat = _nchw(self.compression_modules[i](_nhwc(flat)))
            level = _nhwc(flat)
            staged = level.reshape(B, L, *level.shape[1:])
            fused = self.fuse_modules[i](staged, agent_mask)
            ups.append(self.deblocks[i](_nchw(fused)))
        return _nhwc(torch.cat(ups, dim=1))


class DownsampleConv(nn.Module):
    """Strided double-conv stack."""

    def __init__(self, input_dim: int = 384, dims: Sequence[int] = (256,),
                 kernel_sizes: Sequence[int] = (1,),
                 strides: Sequence[int] = (1,)):
        super().__init__()
        self.layers = nn.ModuleList()
        c_in = input_dim
        for d, k, s in zip(dims, kernel_sizes, strides):
            # reference indices: 0 conv, 1 bn, 2 relu, 3 conv, 4 bn, 5 relu
            self.layers.append(nn.Sequential(
                *_conv_bn_relu(c_in, d, k, s, k // 2),
                *_conv_bn_relu(d, d, k, 1, k // 2)))
            c_in = d

    def forward(self, x):
        """x: (B, H, W, C) NHWC."""
        x = _nchw(x)
        for layer in self.layers:
            x = layer(x)
        return _nhwc(x)

"""BEV decoder, segmentation head and feature compressor.

Counterpart of ``cobevt_tpu/models/heads.py``: ``NaiveDecoder``
(reference ``naive_decoder.py:8``), ``BevSegHead`` (``bev_seg_head.py:10``)
and ``NaiveCompressor`` (``naive_compress.py:5``).  NHWC in and out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.nn.layers import (
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    torch_conv,
)


def upsample_nearest_2x(x):
    """(B, H, W, C) -> (B, 2H, 2W, C), as F.interpolate nearest."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class NaiveDecoder(nn.Module):
    """num_layer x (conv-BN-ReLU, 2x nearest upsample, conv-BN-ReLU).

    The reference keeps its convs in a flat ModuleList ``decoder`` in
    iteration order i = num_layer-1 .. 0 with a parameterless ReLU after
    each BN; the indices are kept for checkpoint porting."""

    def __init__(self, input_dim: int = 128, num_layer: int = 3,
                 num_ch_dec: Sequence[int] = (32, 64, 128)):
        super().__init__()
        mods = []
        in_ch = input_dim
        for i in range(num_layer - 1, -1, -1):
            ch = num_ch_dec[i]
            mods += [torch_conv(in_ch, ch, 3, 1, 1, True), batch_norm(ch),
                     nn.ReLU(), torch_conv(ch, ch, 3, 1, 1, True),
                     batch_norm(ch), nn.ReLU()]
            in_ch = ch
        self.decoder = nn.ModuleList(mods)

    def forward(self, x):
        """x: (B, L, H, W, C) -> (B, L, 8H, 8W, num_ch_dec[0])."""
        B, L, H, W, C = x.shape
        x = x.reshape(B * L, H, W, C)
        for base in range(0, len(self.decoder), 6):
            conv1, bn1, _, conv2, bn2, _ = self.decoder[base:base + 6]
            x = F.relu(bn_nhwc(bn1, conv_nhwc(conv1, x)))
            x = upsample_nearest_2x(x)
            x = F.relu(bn_nhwc(bn2, conv_nhwc(conv2, x)))
        return x.reshape(B, L, *x.shape[1:])


class BevSegHead(nn.Module):
    """3x3 conv logit head(s), target-gated (dynamic / static / both).

    A ``dynamic`` model also owns the unused static head, as the reference
    does (``bev_seg_head.py:13-33``), so checkpoints port 1:1."""

    def __init__(self, target: str = "dynamic", input_dim: int = 32,
                 output_class: int = 2):
        super().__init__()
        self.target = target
        if target != "static":
            self.dynamic_head = torch_conv(input_dim, output_class, 3, 1, 1)
        self.static_head = torch_conv(input_dim, output_class, 3, 1, 1)

    def forward(self, x):
        """x: (B, L, H, W, C) -> dict of (B, L, H, W, classes) logits."""
        B, L, H, W, C = x.shape
        flat = x.reshape(B * L, H, W, C)
        out = {}
        if self.target != "static":
            out["dynamic_seg"] = conv_nhwc(self.dynamic_head, flat).reshape(
                B, L, H, W, -1)
        if self.target != "dynamic":
            out["static_seg"] = conv_nhwc(self.static_head, flat).reshape(
                B, L, H, W, -1)
        if "dynamic_seg" not in out:
            out["dynamic_seg"] = torch.zeros_like(out["static_seg"])
        if "static_seg" not in out:
            out["static_seg"] = torch.zeros_like(out["dynamic_seg"])
        return out


class NaiveCompressor(nn.Module):
    """Conv autoencoder simulating V2V bandwidth limits (BN eps 1e-3,
    momentum 0.01)."""

    def __init__(self, input_dim: int = 128, compress_ratio: int = 4):
        super().__init__()
        hidden = input_dim // compress_ratio
        self.encoder = nn.Sequential(
            torch_conv(input_dim, hidden, 3, 1, 1, True),
            batch_norm(hidden, eps=1e-3, momentum=0.01), nn.ReLU())
        self.decoder = nn.Sequential(
            torch_conv(hidden, input_dim, 3, 1, 1, True),
            batch_norm(input_dim, eps=1e-3, momentum=0.01), nn.ReLU(),
            torch_conv(input_dim, input_dim, 3, 1, 1, True),
            batch_norm(input_dim, eps=1e-3, momentum=0.01), nn.ReLU())

    def forward(self, x):
        for conv, bn in ((self.encoder[0], self.encoder[1]),
                         (self.decoder[0], self.decoder[1]),
                         (self.decoder[3], self.decoder[4])):
            x = F.relu(bn_nhwc(bn, conv_nhwc(conv, x)))
        return x

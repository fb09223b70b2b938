"""Graph-style fusion: V2VNet (ConvGRU message passing) and DiscoNet
(learned per-pixel weights).

Counterpart of ``cobevt_tpu/models/fusion/graph_fusion.py`` (reference
``fusion_modules/v2v_fuse.py:15`` and ``disconet_fuse.py:44``).  As in the
JAX package, every pairwise warp of a batch is one ``warp_affine`` over
(B*L*L) maps, messages and their aggregation are masked tensor ops over the
padded (B, L, ...) layout, and the iterations unroll.  The reference warps
features inside its transpose + flip sandwich but builds the ROI masks in
unflipped space, which holds only for a square BEV: reproduced, and
asserted.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.geometry.transforms import (
    affine_from_discretized,
    discretize_transformation,
)
from cobevt_tpu_torch.geometry.warp import warp_affine
from cobevt_tpu_torch.models.fusion.convgru import ConvGRU
from cobevt_tpu_torch.nn.layers import batch_norm, bn_nhwc, conv_nhwc

NEG_INF = -1e9


def to_flipped(x):
    """Canonical (..., H, W, C) -> the reference's warp orientation
    (transpose H<->W, then flip the trailing original-H axis)."""
    return torch.flip(x.transpose(-3, -2), dims=(-2,))


def from_flipped(y):
    return torch.flip(y, dims=(-2,)).transpose(-3, -2)


def _pairwise_warp_flipped(y, M):
    """Warp every agent's flipped-space map into every agent's frame.

    y: (B, L, W, H, C) in flipped orientation; M: (B, L, L, 2, 3)
    discretized affines, M[b, j, i] mapping j -> i.  Returns (B, L_i, L_j,
    W, H, C) in flipped space."""
    B, L, W, H, C = y.shape
    src = y[:, None].expand(B, L, L, W, H, C).reshape(B * L * L, W, H, C)
    T = affine_from_discretized(M.transpose(1, 2), (W, H))
    out = warp_affine(src, T.reshape(B * L * L, 2, 3), (W, H))
    return out.reshape(B, L, L, W, H, C)


def _pairwise_roi(M, hw):
    """(B, L_i, L_j, H, W) validity of neighbour j's warped map in frame i.

    As the reference (``v2v_fuse.py:80-84``): the ROI warp takes the raw
    discretized affine, with no recentring, so the mask turns about the
    origin and not the image centre."""
    B, L = M.shape[:2]
    H, W = hw
    T = M.transpose(1, 2)                     # [b, i, j] = M[b, j, i]
    ones = torch.ones((B * L * L, H, W, 1), dtype=torch.float32,
                      device=M.device)
    roi = warp_affine(ones, T.reshape(B * L * L, 2, 3), (H, W),
                      mode="nearest")
    return roi.reshape(B, L, L, H, W)


def _graph_inputs(x, agent_mask, pairwise_t_matrix, discrete_ratio,
                  downsample_rate):
    """(M, valid, pair_valid, msg_mask) of a padded (B, L, H, W, C) stack:
    the discretized pairwise affines, the agents' validity in x's dtype,
    its (B, L_i, L_j) product and the ROI-times-pair mask (B, L_i, L_j, H,
    W)."""
    H, W = x.shape[2:4]
    if H != W:
        raise ValueError("graph fusion assumes a square BEV, as the "
                         f"reference does; got {H} x {W}")
    M = discretize_transformation(pairwise_t_matrix, discrete_ratio,
                                  downsample_rate)
    valid = agent_mask.to(x.dtype)
    pair_valid = valid[:, None, :] * valid[:, :, None]
    msg_mask = _pairwise_roi(M, (H, W)) * pair_valid[..., None, None]
    return M, valid, pair_valid, msg_mask


def _pair_stack(y, M):
    """(nb, ego): every neighbour's map warped into every agent's frame and
    the agent's own map beside it, both (B, L_i, L_j, W, H, C)."""
    nb = _pairwise_warp_flipped(y, M)
    return nb, y[:, :, None].expand_as(nb)


class V2VNetFusion(nn.Module):
    """Iterative ConvGRU message passing over the agent graph."""

    def __init__(self, in_channels: int, num_iteration: int = 2,
                 gru_flag: bool = True, agg_operator: str = "avg",
                 discrete_ratio: float = 0.390625, downsample_rate: int = 8,
                 gru_kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        if agg_operator not in ("avg", "max"):
            raise ValueError(f"unknown agg_operator {agg_operator!r}")
        self.num_iteration = num_iteration
        self.gru_flag = gru_flag
        self.agg_operator = agg_operator
        self.discrete_ratio = discrete_ratio
        self.downsample_rate = downsample_rate
        self.msg_cnn = nn.Conv2d(2 * in_channels, in_channels, 3, 1, 1)
        if gru_flag:
            self.conv_gru = ConvGRU(2 * in_channels, (in_channels,),
                                    gru_kernel)
        self.mlp = nn.Linear(in_channels, in_channels)

    def forward(self, x, agent_mask, pairwise_t_matrix):
        """x: (B, L, H, W, C) padded; agent_mask: (B, L); pairwise_t_matrix:
        (B, L, L, 4, 4), [b, j, i] mapping j -> i.  Returns (B, H, W, C)."""
        B, L, H, W, C = x.shape
        M, valid, pair_valid, msg_mask = _graph_inputs(
            x, agent_mask, pairwise_t_matrix, self.discrete_ratio,
            self.downsample_rate)
        dtype = self.msg_cnn.weight.dtype
        feats = x
        for _ in range(self.num_iteration):
            # convolutions run in the reference's flipped orientation
            # (v2v_fuse.py:86-135)
            y = to_flipped(feats)                         # (B, L, W, H, C)
            nb, ego = _pair_stack(y, M)
            msg = conv_nhwc(self.msg_cnn, torch.cat([nb, ego], -1).reshape(
                B * L * L, W, H, 2 * C).to(dtype)).reshape(B, L, L, W, H, C)
            msg = msg * msg_mask[..., None]
            if self.agg_operator == "avg":
                denom = valid.sum(1).clamp(min=1.0)       # (B,)
                agg = msg.sum(dim=2) / denom[:, None, None, None, None]
            else:
                # the reference maxes over the ROI-zeroed messages
                # (v2v_fuse.py:113): zeros take part; only padded agents,
                # absent from its ragged stack, are left out
                agg = msg.masked_fill(
                    pair_valid[..., None, None, None] <= 0, NEG_INF
                ).max(dim=2).values
            if self.gru_flag:
                upd = self.conv_gru(torch.cat([y, agg], -1).reshape(
                    B * L, W, H, 2 * C)).reshape(B, L, W, H, C)
            else:
                upd = y + agg
            feats = from_flipped(upd) * valid[:, :, None, None, None]
        return self.mlp(feats[:, 0].to(dtype))


class PixelWeightedFusionSoftmax(nn.Module):
    """1 x 1 conv stack giving per-pixel agent logits (reference
    ``disconet_fuse.py:16``)."""

    def __init__(self, channel: int):
        super().__init__()
        self.conv1_1 = nn.Conv2d(channel, 128, 1)
        self.bn1_1 = batch_norm(128)
        self.conv1_2 = nn.Conv2d(128, 32, 1)
        self.bn1_2 = batch_norm(32)
        self.conv1_3 = nn.Conv2d(32, 8, 1)
        self.bn1_3 = batch_norm(8)
        self.conv1_4 = nn.Conv2d(8, 1, 1)

    def forward(self, x):
        for conv, bn in ((self.conv1_1, self.bn1_1),
                         (self.conv1_2, self.bn1_2),
                         (self.conv1_3, self.bn1_3)):
            x = F.relu(bn_nhwc(bn, conv_nhwc(conv, x)))
        return F.relu(conv_nhwc(self.conv1_4, x))


class DiscoNetFusion(nn.Module):
    """Pairwise warp + learned per-pixel softmax weights over agents."""

    def __init__(self, in_channels: int, num_iteration: int = 1,
                 use_mask: bool = True, discrete_ratio: float = 0.390625,
                 downsample_rate: int = 8):
        super().__init__()
        self.num_iteration = num_iteration
        self.use_mask = use_mask
        self.discrete_ratio = discrete_ratio
        self.downsample_rate = downsample_rate
        self.pixel_weighted_fusion = PixelWeightedFusionSoftmax(
            2 * in_channels)
        self.mlp = nn.Linear(in_channels, in_channels)

    def forward(self, x, agent_mask, pairwise_t_matrix):
        """As :meth:`V2VNetFusion.forward`; returns (B, H, W, C)."""
        B, L, H, W, C = x.shape
        M, valid, pair_valid, msg_mask = _graph_inputs(
            x, agent_mask, pairwise_t_matrix, self.discrete_ratio,
            self.downsample_rate)
        dtype = self.mlp.weight.dtype
        feats = x
        for _ in range(self.num_iteration):
            nb, ego = _pair_stack(to_flipped(feats), M)   # (B,L,L,W,H,C)
            logits = self.pixel_weighted_fusion(torch.cat([nb, ego], -1)
                                                .reshape(B * L * L, W, H,
                                                         2 * C).to(dtype))
            logits = logits.reshape(B, L, L, W, H)
            keep = msg_mask if self.use_mask else pair_valid[..., None, None]
            logits = logits.masked_fill(keep <= 0, NEG_INF)
            w = F.softmax(logits, dim=2)                  # over neighbours j
            fused = (w[..., None] * nb * msg_mask[..., None]).sum(dim=2)
            feats = from_flipped(fused) * valid[:, :, None, None, None]
        return self.mlp(feats[:, 0].to(dtype))

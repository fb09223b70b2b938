"""PointPillars encoder: pillar feature net + dense BEV scatter.

Counterpart of ``cobevt_tpu/models/lidar/pillar_encoder.py`` (reference
``pillar_vfe.py`` and ``point_pillar_scatter.py``).  The pillar tensor is
padded to a static ``max_voxels`` with a validity mask, as in the JAX
package.  BatchNorm uses OpenPCDet's eps 1e-3 and momentum 0.01 (flax 0.99)
and stores the biased batch variance, as flax does (``nn/layers.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.nn.layers import batch_norm

BN_EPS, BN_MOMENTUM = 1e-3, 0.01


class PFNLayer(nn.Module):
    """Linear -> BN over all point rows -> ReLU -> max over the points of a
    pillar (+ concat with the per-point features if not the last layer)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_norm: bool = True, last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, out_ch, bias=not use_norm)
        # the port's BatchNorm takes any (rows, C, ...) input: here (N*P, C)
        self.norm = batch_norm(out_ch, BN_EPS, BN_MOMENTUM) if use_norm \
            else None

    def forward(self, x):
        """x: (N, P, C), padded point rows already zeroed.  The padded rows'
        transformed values (the BN shift) still take part in the max, as in
        the reference (``pillar_vfe.py:45``); padded *pillars* are masked at
        scatter time."""
        x = self.linear(x.to(self.linear.weight.dtype))
        if self.norm is not None:
            N, P, C = x.shape
            x = self.norm(x.reshape(N * P, C)).reshape(N, P, C)
        x = F.relu(x)
        x_max = x.max(dim=1, keepdim=True).values
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    """Points -> pillar features: augment with the offsets to the pillar's
    point mean and to its cell centre, zero the padding, run the PFN stack."""

    def __init__(self, num_filters: Sequence[int] = (64,),
                 use_norm: bool = True, with_distance: bool = False,
                 use_absolute_xyz: bool = True,
                 voxel_size: Tuple[float, float, float] = (0.4, 0.4, 4.0),
                 point_cloud_range: Tuple[float, ...] = (-70.4, -40, -3,
                                                         70.4, 40, 1),
                 num_point_features: int = 4):
        super().__init__()
        self.with_distance = with_distance
        self.use_absolute_xyz = use_absolute_xyz
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        c_in = (num_point_features if use_absolute_xyz
                else num_point_features - 3) + 6 + int(with_distance)
        filters = [c_in] + list(num_filters)
        self.pfn_layers = nn.ModuleList([
            PFNLayer(filters[i], filters[i + 1], use_norm,
                     last_layer=i == len(filters) - 2)
            for i in range(len(filters) - 1)])

    def forward(self, voxel_features, voxel_num_points, coords):
        """voxel_features: (N, P, 4) [x y z intensity] zero-padded;
        voxel_num_points: (N,); coords: (N, 4) [batch, z, y, x].  Returns
        (N, C_out) pillar features."""
        vx, vy, vz = self.voxel_size
        pr = self.point_cloud_range
        x_off, y_off, z_off = vx / 2 + pr[0], vy / 2 + pr[1], vz / 2 + pr[2]

        vf = voxel_features
        P = vf.shape[1]
        n_pts = voxel_num_points.clamp(min=1).float()
        point_mask = (torch.arange(P, device=vf.device)[None]
                      < voxel_num_points[:, None]).float()

        xyz = vf[..., :3]
        points_mean = (xyz * point_mask[..., None]).sum(1, keepdim=True) \
            / n_pts[:, None, None]
        f_cluster = xyz - points_mean
        centers = torch.stack([coords[:, 3].float() * vx + x_off,
                               coords[:, 2].float() * vy + y_off,
                               coords[:, 1].float() * vz + z_off], dim=-1)
        f_center = xyz - centers[:, None]

        feats = [vf if self.use_absolute_xyz else vf[..., 3:], f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(feats, dim=-1) * point_mask[..., None]
        for pfn in self.pfn_layers:
            features = pfn(features)
        return features[:, 0, :]


class _ScatterSum(torch.autograd.Function):
    """Rows of ``feats`` (N, C) summed per cell index into (n_cells, C); rows
    with index ``n_cells`` are dropped.  The backward is the gather of the
    canvas gradient at each row's cell (zero for a dropped row): exact, in
    the features' dtype, with no atomics."""

    @staticmethod
    def forward(ctx, feats, flat_idx, n_cells):
        N = feats.shape[0]
        sorted_idx, order = torch.sort(flat_idx, stable=True)
        # rows of cell c are sorted rows [start[c], start[c + 1]); the dump
        # row is the last segment
        start = torch.searchsorted(
            sorted_idx, torch.arange(n_cells + 1, device=feats.device))
        lengths = torch.diff(start, append=start.new_full((1,), N))
        canvas = torch.segment_reduce(feats.float()[order], "sum",
                                      lengths=lengths, axis=0)
        ctx.save_for_backward(flat_idx)
        return canvas[:-1].to(feats.dtype)

    @staticmethod
    def backward(ctx, g):
        (flat_idx,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g[flat_idx], None, None


def pillar_scatter(pillar_features, coords, batch_size: int,
                   grid_size: Tuple[int, int, int], voxel_mask=None):
    """Scatter-add (N, C) pillar features into a dense (B, ny, nx, C) canvas.

    coords: (N, 4) [batch, z, y, x]; nz must be 1.  Pillars with
    ``voxel_mask`` false go to one dump row past the canvas, which is
    dropped; they get a zero gradient.

    Deterministic: pillars that share a cell are summed in f32 in the order
    of their rows (a stable sort by cell, then one serial sum per cell) and
    the sum is rounded to the features' dtype once.  An ``index_add_`` on the
    card adds with atomics in no fixed order, so two forwards of one request
    could differ in the last bit; the JAX package's bf16 scatter-add rounds
    after every addend, so in bf16 a cell with colliding pillars can differ
    from it by the roundings this function does not make.  Cells with one
    pillar, and f32, agree exactly.  The backward is a gather
    (:class:`_ScatterSum`), as the JAX scatter-add's is."""
    nx, ny, nz = grid_size
    if nz != 1:
        raise ValueError(f"pillar_scatter needs nz == 1, got {nz}")
    n_cells = batch_size * ny * nx
    C = pillar_features.shape[1]
    flat_idx = (coords[:, 0].long() * (ny * nx) + coords[:, 2].long() * nx
                + coords[:, 3].long())
    if voxel_mask is not None:
        flat_idx = torch.where(voxel_mask, flat_idx,
                               torch.full_like(flat_idx, n_cells))
    canvas = _ScatterSum.apply(pillar_features, flat_idx, n_cells)
    return canvas.reshape(batch_size, ny, nx, C)

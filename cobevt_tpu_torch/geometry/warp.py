"""Affine warping of NHWC feature maps, and the STTF ego warp.

Counterpart of ``cobevt_tpu/geometry/warp.py``.  The sampling location for
destination pixel p is ``M^-1 p`` in pixel coordinates (the reference's
normalize / affine_grid / grid_sample(align_corners=True) chain composed
algebraically).  The sampler is a literal port of the JAX one -- floor,
four corners, per-corner validity, clipped gather, ``round`` for nearest --
and not ``F.grid_sample``, whose edge handling differs.
"""

from __future__ import annotations

import torch

from cobevt_tpu_torch.geometry.transforms import (
    affine_from_discretized,
    discretize_transformation,
)


def _invert_affine_2x3(M):
    """Invert (..., 2, 3) affines: p_src = R^-1 (p_dst - t)."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(det.abs() < 1e-12,
                                torch.full_like(det, 1e-12), det)
    ia = d * inv_det
    ib = -b * inv_det
    ic = -c * inv_det
    id_ = a * inv_det
    tx, ty = M[..., 0, 2], M[..., 1, 2]
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_grid_pixel(M, dsize):
    """(..., H_out, W_out, 2) source (x, y) pixel coordinates of every
    destination pixel, for (..., 2, 3) destination<-source affines M."""
    H, W = dsize
    Minv = _invert_affine_2x3(M.float())
    ys = torch.arange(H, dtype=torch.float32, device=M.device)
    xs = torch.arange(W, dtype=torch.float32, device=M.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")        # (H, W)
    p = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    return torch.einsum("...ij,hwj->...hwi", Minv, p)


def grid_sample(src, coords, mode: str = "bilinear"):
    """Sample ``src`` (B, H, W, C) at pixel ``coords`` (B, Ho, Wo, 2)
    (x = width index, y = height index).  Out-of-bounds corners contribute
    zero."""
    B, H, W, C = src.shape
    Ho, Wo = coords.shape[1:3]
    x = coords[..., 0]
    y = coords[..., 1]
    flat = src.reshape(B, H * W, C)

    def gather(ix, iy):
        idx = (iy * W + ix).reshape(B, Ho * Wo, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, Ho, Wo, C)

    def in_bounds(ix, iy):
        return (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)

    if mode == "nearest":
        ix = torch.round(x).long()
        iy = torch.round(y).long()
        valid = in_bounds(ix, iy)
        out = gather(ix.clamp(0, W - 1), iy.clamp(0, H - 1))
        return out * valid[..., None].to(src.dtype)

    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")

    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(src.dtype)
    wy = (y - y0f).to(src.dtype)
    x0 = x0f.long()
    y0 = y0f.long()

    out = torch.zeros((B, Ho, Wo, C), dtype=src.dtype, device=src.device)
    for dx, dy, w in (
        (0, 0, (1 - wx) * (1 - wy)),
        (1, 0, wx * (1 - wy)),
        (0, 1, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        ix = x0 + dx
        iy = y0 + dy
        valid = in_bounds(ix, iy)
        v = gather(ix.clamp(0, W - 1), iy.clamp(0, H - 1))
        out = out + v * (w * valid.to(src.dtype))[..., None]
    return out


def warp_affine(src, M, dsize, mode: str = "bilinear"):
    """Warp (B, H, W, C) by pixel-space affines M (B, 2, 3) to ``dsize``."""
    return grid_sample(src, affine_grid_pixel(M, dsize), mode=mode)


def sttf_warp(x, transformation_matrix, discrete_ratio: float,
              downsample_rate: float):
    """Warp every agent's BEV features (B, L, H, W, C) into the ego frame
    by the (B, L, 4, 4) agent->ego SE(3) (reference ``STTF.forward``,
    ``opv2v/opencood/models/corpbevt.py:22-64``): discretize to a pixel
    affine, then warp inside a transpose+flip sandwich that maps the
    (x-forward, y-left) BEV convention onto row/col order."""
    B, L, H, W, C = x.shape
    M = discretize_transformation(transformation_matrix, discrete_ratio,
                                  downsample_rate)      # (B, L, 2, 3)
    y = torch.flip(x.transpose(2, 3), dims=(3,))         # (B, L, W, H, C)
    T = affine_from_discretized(M, (W, H))
    y = warp_affine(y.reshape(B * L, W, H, C), T.reshape(B * L, 2, 3),
                    (W, H))
    y = y.reshape(B, L, W, H, C)
    return torch.flip(y, dims=(3,)).transpose(2, 3)


def rotated_roi_mask(shape, transformation_matrix, discrete_ratio: float,
                     downsample_rate: float):
    """(B, L, H, W) f32 validity of each agent's warped field of view: an
    all-ones map warped nearest-neighbour by the same affine, without the
    STTF sandwich, as the reference's ``get_rotated_roi``."""
    B, L, H, W = shape
    M = discretize_transformation(transformation_matrix, discrete_ratio,
                                  downsample_rate)
    T = affine_from_discretized(M, (H, W))
    ones = torch.ones((B * L, H, W, 1), dtype=torch.float32,
                      device=transformation_matrix.device)
    mask = warp_affine(ones, T.reshape(B * L, 2, 3), (H, W), mode="nearest")
    return mask.reshape(B, L, H, W)


def roi_and_agent_mask(shape, agent_mask, transformation_matrix,
                       discrete_ratio: float, downsample_rate: float):
    """(B, L, H, W) warped ROI validity times agent validity (B, L)."""
    roi = rotated_roi_mask(shape, transformation_matrix, discrete_ratio,
                           downsample_rate)
    return roi * agent_mask[:, :, None, None].to(roi.dtype)

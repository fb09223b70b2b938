"""nuScenes visualization: a camera strip over colorized BEV panels.

Counterpart of ``cobevt_tpu/utils/nuscenes_viz.py`` (reference
``nuscenes/cross_view_transformer/visualizations/common.py:77`` and
``nuscenes_viz.py:5``): the cameras of a sample side by side, with the
ground-truth BEV (and a prediction, if given) below, as ``tools/
view_data.py`` writes them.  Resizes are :func:`resize_linear` on every
machine, within 1 level of OpenCV's bilinear ``resize``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

BEV_COLOR = np.array([60, 60, 220], np.uint8)     # vehicles (BGR)
BG_COLOR = np.array([255, 255, 255], np.uint8)


def resize_linear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 by bilinear sampling at pixel
    centres without a widened filter (``cv2.resize``'s ``INTER_LINEAR``),
    rounded."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return np.ascontiguousarray(
        y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy())


def colorize_bev(bev: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """(H, W) probability or binary map -> (H, W, 3) uint8."""
    img = np.tile(BG_COLOR, (*bev.shape, 1))
    img[bev > threshold] = BEV_COLOR
    return img


def camera_strip(images: np.ndarray, height: int = 160) -> np.ndarray:
    """(n, H, W, 3) float [0, 1] -> one horizontal uint8 strip."""
    tiles = []
    for img in images:
        u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
        scale = height / u8.shape[0]
        tiles.append(resize_linear(u8, (height, int(u8.shape[1] * scale))))
    return np.concatenate(tiles, axis=1)


def sample_panel(batch: Dict, pred_bev: Optional[np.ndarray] = None,
                 index: int = 0) -> np.ndarray:
    """Camera strip on top; the ground-truth BEV (and the prediction's, if
    given) below."""
    strip = camera_strip(np.asarray(batch["image"])[index])
    panels = []
    if "bev" in batch:
        gt = np.asarray(batch["bev"])[index]
        panels.append(colorize_bev(gt.max(-1) if gt.ndim == 3 else gt))
    if pred_bev is not None:
        prob = 1 / (1 + np.exp(-np.asarray(pred_bev)[index, ..., 0]))
        panels.append(colorize_bev(prob))
    if not panels:
        return strip
    bev_row = np.concatenate(panels, axis=1)
    scale = strip.shape[1] / bev_row.shape[1]
    bev_row = resize_linear(bev_row, (int(bev_row.shape[0] * scale),
                                      strip.shape[1]))
    return np.concatenate([strip, bev_row], axis=0)

"""PIXOR-style BEV detection post-processing.

Counterpart of ``cobevt_tpu/postprocess/lidar_bev_postprocessor.py``
(reference ``lidar_bev_postprocessor.py``), numpy on the host:
``generate_label`` paints a class channel and six normalized regression
channels (cos yaw, sin yaw, dx, dy, log w, log l) inside each rotated
ground-truth footprint, by a half-plane test over the label grid;
``denormalize_reg_map``; ``decode`` thresholds the class map, decodes each
pixel's box and runs rotated NMS (``utils/native_ops.py:nms_rotated``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from cobevt_tpu_torch.geometry import boxes as box_ops
from cobevt_tpu_torch.utils import native_ops

DEFAULT_TARGET_MEAN = np.array([0.008, 0.001, 0.202, 0.2, 0.43, 1.368],
                               np.float32)
DEFAULT_TARGET_STD = np.array([0.866, 0.5, 0.954, 0.668, 0.09, 0.111],
                              np.float32)


@dataclasses.dataclass(frozen=True)
class BevGeometry:
    L1: float = -40.0
    W1: float = -40.0
    res: float = 0.2
    downsample_rate: int = 2
    label_shape: Tuple[int, int, int] = (200, 200, 7)


def _points_in_rotated_box(points, corners):
    """(P, 2) int grid points inside a (4, 2) rotated rectangle."""
    inside = np.ones(len(points), bool)
    area = 0.0
    for e in range(4):
        a, b = corners[e], corners[(e + 1) % 4]
        area += a[0] * b[1] - b[0] * a[1]
    sign = 1.0 if area >= 0 else -1.0
    for e in range(4):
        a, b = corners[e], corners[(e + 1) % 4]
        cross = ((b[0] - a[0]) * (points[:, 1] - a[1]) -
                 (b[1] - a[1]) * (points[:, 0] - a[0]))
        inside &= cross * sign >= 0
    return inside


class LidarBevPostprocessor:
    def __init__(self, geometry: BevGeometry = BevGeometry(),
                 target_mean=DEFAULT_TARGET_MEAN,
                 target_std=DEFAULT_TARGET_STD,
                 score_threshold: float = 0.3,
                 nms_threshold: float = 0.15, max_num: int = 100,
                 order: str = "lwh"):
        self.geo = geometry
        self.target_mean = np.asarray(target_mean, np.float32)
        self.target_std = np.asarray(target_std, np.float32)
        self.score_threshold = score_threshold
        self.nms_threshold = nms_threshold
        self.max_num = max_num
        self.order = order

    def generate_label(self, gt_box_center: np.ndarray,
                       mask: np.ndarray) -> Dict[str, np.ndarray]:
        """(max_num, 7) lwh boxes + mask -> (H, W, 7) normalized label
        map (channel 0 = class, 1..6 = regression)."""
        if self.order != "lwh":
            raise ValueError(f"generate_label takes lwh boxes, got "
                             f"{self.order}")
        geo = self.geo
        gt = gt_box_center[mask == 1]
        label = np.zeros(geo.label_shape, np.float64)
        if len(gt):
            corners = box_ops.boxes_to_corners2d(gt, self.order)[:, :, :2]
            scale = geo.res * geo.downsample_rate
            origin = np.array([geo.L1, geo.W1])
            corners_dist = (corners - origin) / scale

            xs = np.arange(geo.label_shape[0])
            ys = np.arange(geo.label_shape[1])
            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            pts = np.stack([gx.ravel(), gy.ravel()], -1)

            yaw = gt[:, 6]
            regs = np.column_stack([np.cos(yaw), np.sin(yaw), gt[:, 0],
                                    gt[:, 1], gt[:, 3], gt[:, 4]])
            for i in range(len(gt)):
                inside = _points_in_rotated_box(pts, corners_dist[i])
                pin = pts[inside]
                if not len(pin):
                    continue
                continuous = (pin + origin / scale) * scale
                tgt = np.repeat(regs[i][None], len(pin), 0)
                tgt[:, 2:4] -= continuous
                tgt[:, 4:] = np.log(tgt[:, 4:])
                label[pin[:, 0], pin[:, 1], 0] = 1.0
                label[pin[:, 0], pin[:, 1], 1:] = tgt
        label[..., 1:] = (label[..., 1:] - self.target_mean) / \
            self.target_std
        return {"label_map": label.astype(np.float32)}

    def denormalize_reg_map(self, reg_map):
        return reg_map * self.target_std + self.target_mean

    def decode(self, cls_map: np.ndarray, reg_map: np.ndarray):
        """(H, W) logits + (H, W, 6) normalized regression -> kept
        (K, 4, 2) BEV corners + scores."""
        geo = self.geo
        probs = 1 / (1 + np.exp(-cls_map))
        keep = probs > self.score_threshold
        if not keep.any():
            return np.zeros((0, 4, 2)), np.zeros((0,))
        reg = self.denormalize_reg_map(reg_map[keep])
        idx = np.argwhere(keep)
        scale = geo.res * geo.downsample_rate
        origin = np.array([geo.L1, geo.W1])
        pix = (idx + origin / scale) * scale
        cos_t, sin_t = reg[:, 0], reg[:, 1]
        centers = reg[:, 2:4] + pix
        dims = np.exp(reg[:, 4:6])
        yaw = np.arctan2(sin_t, cos_t)
        boxes2d = np.column_stack([centers, dims, yaw])
        corners = box_ops.boxes2d_to_corners2d(boxes2d)
        scores = probs[keep]
        kept = native_ops.nms_rotated(corners, scores,
                                      self.nms_threshold)[:self.max_num]
        return corners[kept], scores[kept]

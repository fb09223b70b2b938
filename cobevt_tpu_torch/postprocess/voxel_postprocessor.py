"""Anchor-based detection post-processing (VoxelNet / PointPillars style).

Counterpart of ``cobevt_tpu/postprocess/voxel_postprocessor.py`` (reference
``data_utils/post_processor/voxel_postprocessor.py``), numpy on the host:
``generate_anchor_box`` (the anchor grid over the LiDAR range),
``VoxelPostprocessor.generate_label`` (IoU target assignment on standup 2-D
boxes, through ``utils/native_ops.py:bbox_overlaps``),
``VoxelPostprocessor.decode`` (sigmoid scores, anchor-delta decoding, the
score threshold and rotated NMS through ``native_ops.nms_rotated``) and
``delta_to_boxes3d``.  The box helpers are ``geometry/boxes.py``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

from cobevt_tpu_torch.geometry.boxes import (  # noqa: F401 (re-exported)
    bbox_overlaps,
    boxes_to_corners_3d,
)
from cobevt_tpu_torch.utils import native_ops


@dataclasses.dataclass(frozen=True)
class AnchorArgs:
    cav_lidar_range: Tuple[float, ...] = (-70.4, -40, -3, 70.4, 40, 1)
    l: float = 3.9
    w: float = 1.6
    h: float = 1.56
    r: Tuple[float, ...] = (0.0, 90.0)
    vw: float = 0.4
    vh: float = 0.4
    W: int = 352
    H: int = 200
    feature_stride: int = 2


def generate_anchor_box(args: AnchorArgs, order: str = "hwl"):
    """(H/fs, W/fs, anchor_num, 7) anchors over the lidar range."""
    anchor_num = len(args.r)
    r = [math.radians(x) for x in args.r]
    xr = (args.cav_lidar_range[0], args.cav_lidar_range[3])
    yr = (args.cav_lidar_range[1], args.cav_lidar_range[4])
    x = np.linspace(xr[0] + args.vw, xr[1] - args.vw,
                    args.W // args.feature_stride)
    y = np.linspace(yr[0] + args.vh, yr[1] - args.vh,
                    args.H // args.feature_stride)
    cx, cy = np.meshgrid(x, y)
    cx = np.tile(cx[..., None], anchor_num)
    cy = np.tile(cy[..., None], anchor_num)
    cz = np.full_like(cx, -1.0)
    w = np.full_like(cx, args.w)
    l = np.full_like(cx, args.l)
    h = np.full_like(cx, args.h)
    rr = np.stack([np.full_like(cx[..., 0], ri) for ri in r], -1)
    if order == "hwl":
        return np.stack([cx, cy, cz, h, w, l, rr], axis=-1)
    if order == "lhw":
        return np.stack([cx, cy, cz, l, h, w, rr], axis=-1)
    raise ValueError(order)


def corner2d_to_standup(corners):
    """(N, 4+, d) corners -> (N, 4) [x1 y1 x2 y2] axis-aligned hull."""
    c = np.asarray(corners)
    return np.stack([c[..., 0].min(-1), c[..., 1].min(-1),
                     c[..., 0].max(-1), c[..., 1].max(-1)], -1)




class VoxelPostprocessor:
    """The anchors of one detector, the labels they get from ground-truth
    boxes, and the boxes decoded from its maps (every ``native_ops`` call
    on its native route)."""

    def __init__(self, anchor_args: AnchorArgs, order: str = "hwl",
                 pos_threshold: float = 0.6, neg_threshold: float = 0.45,
                 score_threshold: float = 0.2, nms_threshold: float = 0.15,
                 max_num: int = 100):
        self.args = anchor_args
        self.order = order
        self.anchor_num = len(anchor_args.r)
        self.pos_threshold = pos_threshold
        self.neg_threshold = neg_threshold
        self.score_threshold = score_threshold
        self.nms_threshold = nms_threshold
        self.max_num = max_num
        self.anchors = generate_anchor_box(anchor_args, order)

    # -- training targets ---------------------------------------------------

    def generate_label(self, gt_box_center: np.ndarray,
                       mask: np.ndarray) -> Dict[str, np.ndarray]:
        """IoU-assign anchors to ground-truth boxes.

        gt_box_center: (max_num, 7) hwl-order boxes; mask: (max_num,) with 1
        for a valid box.  Returns pos_equal_one, neg_equal_one (H, W, A) and
        targets (H, W, A * 7): an anchor is positive above ``pos_threshold``
        IoU or as the best anchor of a box, negative when it stays under
        ``neg_threshold`` for every box."""
        if self.order != "hwl":
            raise ValueError(f"generate_label takes hwl boxes, got "
                             f"{self.order}")
        anchors = self.anchors
        fm_shape = anchors.shape[:2]
        flat = anchors.reshape(-1, 7)
        anchors_d = np.sqrt(flat[:, 4] ** 2 + flat[:, 5] ** 2)

        pos = np.zeros((*fm_shape, self.anchor_num))
        neg = np.zeros((*fm_shape, self.anchor_num))
        targets = np.zeros((*fm_shape, self.anchor_num * 7))

        gt_valid = gt_box_center[mask == 1]
        if len(gt_valid) == 0:
            neg[:] = 1
            return {"pos_equal_one": pos, "neg_equal_one": neg,
                    "targets": targets}

        gt_corners = boxes_to_corners_3d(gt_valid, self.order)
        anchor_corners = boxes_to_corners_3d(flat, self.order)
        iou = native_ops.bbox_overlaps(
            corner2d_to_standup(anchor_corners[:, :4]).astype(np.float32),
            corner2d_to_standup(gt_corners[:, :4]).astype(np.float32))

        # best anchor per box (always positive)
        id_highest = np.argmax(iou.T, axis=1)
        id_highest_gt = np.arange(iou.shape[1])
        keep = iou.T[id_highest_gt, id_highest] > 0
        id_highest, id_highest_gt = id_highest[keep], id_highest_gt[keep]

        id_pos, id_pos_gt = np.where(iou > self.pos_threshold)
        id_neg = np.where((iou < self.neg_threshold).sum(1) ==
                          iou.shape[1])[0]
        id_pos = np.concatenate([id_pos, id_highest])
        id_pos_gt = np.concatenate([id_pos_gt, id_highest_gt])
        id_pos, index = np.unique(id_pos, return_index=True)
        id_pos_gt = id_pos_gt[index]

        ix, iy, iz = np.unravel_index(id_pos, (*fm_shape, self.anchor_num))
        pos[ix, iy, iz] = 1
        gtv = gt_box_center
        targets[ix, iy, iz * 7 + 0] = (gtv[id_pos_gt, 0] -
                                       flat[id_pos, 0]) / anchors_d[id_pos]
        targets[ix, iy, iz * 7 + 1] = (gtv[id_pos_gt, 1] -
                                       flat[id_pos, 1]) / anchors_d[id_pos]
        targets[ix, iy, iz * 7 + 2] = (gtv[id_pos_gt, 2] -
                                       flat[id_pos, 2]) / flat[id_pos, 3]
        for k in (3, 4, 5):
            targets[ix, iy, iz * 7 + k] = np.log(
                gtv[id_pos_gt, k] / flat[id_pos, k])
        targets[ix, iy, iz * 7 + 6] = gtv[id_pos_gt, 6] - flat[id_pos, 6]

        nx_, ny_, nz_ = np.unravel_index(id_neg, (*fm_shape, self.anchor_num))
        neg[nx_, ny_, nz_] = 1
        hx, hy, hz = np.unravel_index(id_highest,
                                      (*fm_shape, self.anchor_num))
        neg[hx, hy, hz] = 0
        return {"pos_equal_one": pos, "neg_equal_one": neg,
                "targets": targets}

    # -- inference ----------------------------------------------------------

    def decode(self, cls_preds: np.ndarray, reg_preds: np.ndarray):
        """One sample's maps -> kept boxes: sigmoid scores, anchor-delta
        decoding, the score threshold, rotated NMS on the BEV corners, the
        first ``max_num`` kept.

        cls_preds: (H, W, anchor_num); reg_preds: (H, W, anchor_num * 7).
        Returns (corners3d (K, 8, 3), scores (K,))."""
        scores = 1 / (1 + np.exp(-cls_preds.reshape(-1)))
        boxes = delta_to_boxes3d(reg_preds[None], self.anchors)[0]
        keep = scores > self.score_threshold
        boxes, scores = boxes[keep], scores[keep]
        if len(boxes) == 0:
            return np.zeros((0, 8, 3)), np.zeros((0,))
        corners = boxes_to_corners_3d(boxes, self.order)
        keep_idx = native_ops.nms_rotated(
            corners[:, :4, :2], scores, self.nms_threshold)
        keep_idx = keep_idx[:self.max_num]
        return corners[keep_idx], scores[keep_idx]


def delta_to_boxes3d(deltas, anchors):
    """(N, H, W, anchor_num * 7) deltas + (H, W, anchor_num, 7) anchors ->
    (N, H * W * anchor_num, 7) decoded boxes (channels last)."""
    deltas = np.asarray(deltas)
    N = deltas.shape[0]
    d = deltas.reshape(N, -1, 7)
    a = np.asarray(anchors).reshape(-1, 7).astype(np.float64)
    a_d = np.sqrt(a[:, 4] ** 2 + a[:, 5] ** 2)

    out = np.zeros_like(d, dtype=np.float64)
    out[..., 0] = d[..., 0] * a_d + a[None, :, 0]
    out[..., 1] = d[..., 1] * a_d + a[None, :, 1]
    out[..., 2] = d[..., 2] * a[None, :, 3] + a[None, :, 2]
    out[..., 3:6] = np.exp(d[..., 3:6]) * a[None, :, 3:6]
    out[..., 6] = d[..., 6] + a[None, :, 6]
    return out

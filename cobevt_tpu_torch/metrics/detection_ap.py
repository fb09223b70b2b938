"""Detection AP (VOC-2010 style) for the LiDAR track.

Counterpart of ``cobevt_tpu/metrics/detection_ap.py`` (reference
``utils/eval_utils.py``: ``voc_ap`` :10, ``caluclate_tp_fp`` :36,
``calculate_ap`` :90): detections matched greedily in score order to the
ground truth by rotated BEV IoU (``utils/native_ops.py:rotated_iou``),
then the all-point interpolated AP.  numpy on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from cobevt_tpu_torch.utils import native_ops


def new_result_stat(iou_thresholds=(0.5, 0.7)) -> Dict:
    return {t: {"tp": [], "fp": [], "gt": 0} for t in iou_thresholds}


def accumulate_tp_fp(det_corners, det_scores, gt_corners, result_stat,
                     iou_thresh: float):
    """Greedy score-ordered matching of detections to GT boxes.

    det_corners / gt_corners: (N, 4, 2) BEV rectangle corners (take
    `corners3d[:, :4, :2]` for 3D boxes).  The IoUs come from
    ``native_ops.rotated_iou`` on its native route.
    """
    stat = result_stat[iou_thresh]
    stat["gt"] += len(gt_corners)
    if det_corners is None or len(det_corners) == 0:
        return
    order = np.argsort(-np.asarray(det_scores))
    remaining = list(range(len(gt_corners)))
    ious_all = native_ops.rotated_iou(np.asarray(det_corners),
                                      np.asarray(gt_corners)) \
        if len(gt_corners) else np.zeros((len(det_corners), 0))
    for i in order:
        if remaining:
            ious = ious_all[i, remaining]
            best = int(np.argmax(ious))
            if ious[best] >= iou_thresh:
                stat["tp"].append(1)
                stat["fp"].append(0)
                remaining.pop(best)
                continue
        stat["tp"].append(0)
        stat["fp"].append(1)


def voc_ap(recall: List[float], precision: List[float]):
    mrec = [0.0] + list(recall) + [1.0]
    mpre = [0.0] + list(precision) + [0.0]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap, mrec, mpre


def calculate_ap(result_stat, iou_thresh: float):
    stat = result_stat[iou_thresh]
    fp = np.cumsum(stat["fp"]).astype(float)
    tp = np.cumsum(stat["tp"]).astype(float)
    if stat["gt"] == 0 or len(tp) == 0:
        return 0.0, [], []
    rec = (tp / stat["gt"]).tolist()
    prec = (tp / np.maximum(tp + fp, 1e-12)).tolist()
    return voc_ap(rec, prec)

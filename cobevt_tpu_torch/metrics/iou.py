"""IoU metrics, as summable counter states.

Counterpart of ``cobevt_tpu/metrics/iou.py``: threshold IoU with tp/fp/fn
counters (reference ``nuscenes/cross_view_transformer/metrics.py:7-36``)
and per-class mean IoU on argmax maps (reference
``opv2v/opencood/utils/seg_utils.py:25``).  Counters are f32 tensors, so
states from several replicas add.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class IoUState:
    """tp/fp/fn counters per threshold (and optionally per channel)."""

    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor

    @staticmethod
    def create(num_thresholds: int = 2, channels: int = 1,
               device=None) -> "IoUState":
        def z():
            return torch.zeros((channels, num_thresholds),
                               dtype=torch.float32, device=device)
        return IoUState(z(), z(), z())


@torch.no_grad()
def iou_update(state: IoUState, logits, label, thresholds=(0.4, 0.5),
               visibility=None, min_visibility: Optional[int] = None,
               label_indices=None) -> IoUState:
    """Accumulate threshold-IoU counters.

    logits: (B, H, W, C) raw scores; label: (B, H, W, n) {0,1};
    visibility: (B, H, W) ints.  ``label_indices`` folds label channels
    into groups (a group is set where any of its channels is > 0.5)."""
    probs = torch.sigmoid(logits.float())
    label = label.float()
    if label_indices is not None:
        member = np.zeros((label.shape[-1], len(label_indices)), np.float32)
        for g, idx in enumerate(label_indices):
            member[list(idx), g] = 1.0
        label = (label > 0.5).float()
        label = (label @ torch.from_numpy(member).to(label.device)).clamp(
            max=1.0)
    thr = torch.tensor(thresholds, dtype=torch.float32, device=probs.device)

    pred = probs[..., None] >= thr                     # (B,H,W,C,T)
    lab = label[..., None] > 0.5                       # (B,H,W,C,1)
    if min_visibility is not None:
        keep = (visibility >= min_visibility)[..., None, None]
    else:
        keep = torch.ones(probs.shape[:3], dtype=torch.bool,
                          device=probs.device)[..., None, None]

    tp = (pred & lab & keep).sum((0, 1, 2)).float()
    fp = (pred & ~lab & keep).sum((0, 1, 2)).float()
    fn = (~pred & lab & keep).sum((0, 1, 2)).float()
    return IoUState(state.tp + tp, state.fp + fp, state.fn + fn)


def iou_compute(state: IoUState):
    """(channels, thresholds) IoU tensor."""
    return state.tp / (state.tp + state.fp + state.fn + 1e-7)


def confusion_counts(pred, gt, num_classes: int):
    """Confusion matrix counts (num_classes, num_classes): rows = gt."""
    idx = gt.long() * num_classes + pred.long()
    counts = torch.bincount(idx.reshape(-1),
                            minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).float()


def per_class_iou(confusion):
    """IoU per class from a confusion matrix (diag / (row+col-diag))."""
    diag = torch.diagonal(confusion)
    denom = confusion.sum(0) + confusion.sum(1) - diag
    return diag / denom.clamp(min=1e-7)


def mean_iou_reference(pred: np.ndarray, gt: np.ndarray,
                       num_classes: int) -> list:
    """Host-side per-class IoU with the reference's skip rule: a class
    scores 0 unless it appears in *both* prediction and GT
    (reference seg_utils.py:41-49).  Operates on one (H, W) map pair."""
    ious = []
    for c in range(num_classes):
        p = pred == c
        g = gt == c
        if p.sum() == 0 or g.sum() == 0:
            ious.append(0.0)
            continue
        inter = np.logical_and(p, g).sum()
        union = p.sum() + g.sum() - inter
        ious.append(float(inter) / float(union))
    return ious

"""Segmentation losses of the OPV2V camera track.

Counterpart of ``cobevt_tpu/losses/seg_losses.py``: ``VanillaSegLoss``
(reference ``opv2v/opencood/loss/vanilla_seg_loss.py:7``), a
class-weighted cross entropy with torch's weighted-mean normalisation, and
``sigmoid_focal_loss``, which the LiDAR detection loss takes.  The nuScenes
losses of that file come with their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def weighted_cross_entropy(logits, labels, class_weights, valid_mask=None):
    """torch ``CrossEntropyLoss(weight=w)`` semantics, in f32.

    logits: (..., C) raw scores; labels: (...) int; class_weights: (C,).
    Returns sum(w[y]*ce) / max(sum(w[y]), 1e-12) over valid entries.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[labels]
    if valid_mask is not None:
        w = w * valid_mask
    return -(w * picked).sum() / w.sum().clamp(min=1e-12)


def sigmoid_bce(logits, labels):
    """Numerically stable binary cross entropy with logits, elementwise."""
    return logits.clamp(min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = -1.0,
                       gamma: float = 2.0):
    """fvcore-style sigmoid focal loss, elementwise (no reduction)."""
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


@dataclasses.dataclass(frozen=True)
class VanillaSegLoss:
    """total = s_coe * static_CE + d_coe * dynamic_CE."""

    target: str = "dynamic"
    d_weights: float = 75.0
    s_weights: float = 15.0
    l_weights: float = 50.0
    d_coe: float = 2.0
    s_coe: float = 0.0

    def __call__(self, output_dict: Dict, gt_dict: Dict):
        """output_dict: {static_seg, dynamic_seg} logits (B, L, H, W, C);
        gt_dict: {gt_static, gt_dynamic} int labels (B, L, H, W).
        Returns (total_loss, {static_loss, dynamic_loss, total_loss})."""
        some = next(iter(output_dict.values()))
        static_loss = torch.zeros((), device=some.device)
        dynamic_loss = torch.zeros((), device=some.device)
        if self.target in ("dynamic", "both"):
            dynamic_loss = weighted_cross_entropy(
                output_dict["dynamic_seg"], gt_dict["gt_dynamic"],
                [1.0, self.d_weights])
        if self.target in ("static", "both"):
            static_loss = weighted_cross_entropy(
                output_dict["static_seg"], gt_dict["gt_static"],
                [1.0, self.s_weights, self.l_weights])
        total = self.s_coe * static_loss + self.d_coe * dynamic_loss
        return total, {"static_loss": static_loss,
                       "dynamic_loss": dynamic_loss,
                       "total_loss": total}

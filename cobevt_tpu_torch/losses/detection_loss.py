"""Anchor-based detection loss of the LiDAR track (PointPillars recipe).

Counterpart of ``cobevt_tpu/losses/detection_loss.py``: focal classification
over the positive and negative anchors plus smooth-L1 regression on the
positives with the sin-difference encoding of the angle residual, both
normalised by the number of positives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from cobevt_tpu_torch.losses.seg_losses import sigmoid_focal_loss


def smooth_l1(x, beta: float = 1.0 / 9.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


@dataclasses.dataclass(frozen=True)
class PointPillarLoss:
    cls_weight: float = 1.0
    reg_weight: float = 2.0
    alpha: float = 0.25
    gamma: float = 2.0
    anchor_num: int = 2

    def __call__(self, output: Dict, target: Dict):
        """output: cls_preds (B, H, W, A), reg_preds (B, H, W, A*7); target:
        pos_equal_one / neg_equal_one (B, H, W, A), targets (B, H, W, A*7).
        Returns (total, {cls_loss, reg_loss, total_loss}) in the
        predictions' dtype."""
        cls_preds = output["cls_preds"]
        reg_preds = output["reg_preds"]
        pos = target["pos_equal_one"].to(cls_preds.dtype)
        neg = target["neg_equal_one"].to(cls_preds.dtype)

        num_pos = pos.sum().clamp(min=1.0)

        cls_all = sigmoid_focal_loss(cls_preds, pos, self.alpha, self.gamma)
        cls_loss = (cls_all * (pos + neg)).sum() / num_pos

        B = reg_preds.shape[0]
        reg_p = reg_preds.reshape(B, -1, 7)
        reg_t = target["targets"].to(reg_preds.dtype).reshape(B, -1, 7)
        pos_flat = pos.reshape(B, -1)

        # sin-difference encoding of the angle residual
        sin_diff = (torch.sin(reg_p[..., 6]) * torch.cos(reg_t[..., 6]) -
                    torch.cos(reg_p[..., 6]) * torch.sin(reg_t[..., 6]))
        resid = torch.cat(
            [reg_p[..., :6] - reg_t[..., :6], sin_diff[..., None]], -1)
        reg_loss = (smooth_l1(resid).sum(-1) * pos_flat).sum() / num_pos

        total = self.cls_weight * cls_loss + self.reg_weight * reg_loss
        return total, {"cls_loss": cls_loss, "reg_loss": reg_loss,
                       "total_loss": total}

"""Segmentation losses of both tracks.

Counterpart of ``cobevt_tpu/losses/seg_losses.py``:

  * ``VanillaSegLoss`` -- reference
    ``opv2v/opencood/loss/vanilla_seg_loss.py:7``, a class-weighted cross
    entropy with torch's weighted-mean normalisation;
  * ``sigmoid_focal_loss`` -- fvcore semantics, which the nuScenes losses and
    the LiDAR detection loss take;
  * ``BinarySegmentationLoss`` / ``CenterLoss`` -- reference
    ``nuscenes/cross_view_transformer/losses.py:27/:59``: the focal loss,
    optionally over the pixels of visibility >= ``min_visibility`` only
    (mean over the kept pixels);
  * ``MultipleLoss`` -- reference ``losses.py:82``: a weighted sum, with the
    unweighted parts.

The nuScenes losses compute in the logits' dtype (labels are cast to it),
as the JAX criterion does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from cobevt_tpu_torch.parallel.distributed import rank_mean_denominator


def weighted_cross_entropy(logits, labels, class_weights, valid_mask=None):
    """torch ``CrossEntropyLoss(weight=w)`` semantics, in f32.

    logits: (..., C) raw scores; labels: (...) int; class_weights: (C,).
    Returns sum(w[y]*ce) / max(sum(w[y]), 1e-12) over valid entries (the
    sum of weights over every rank's batch in a data-parallel step:
    ``parallel/distributed.py:rank_mean_denominator``).
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[labels]
    if valid_mask is not None:
        w = w * valid_mask
    return -(w * picked).sum() / rank_mean_denominator(w.sum()).clamp(
        min=1e-12)


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


def _masked_mean(loss, mask):
    """Mean of ``loss`` over the entries where ``mask`` holds (all of them
    without a mask); the denominator is clamped at 1e-12, so a batch with
    no kept pixel gives 0, not NaN, and taken over every rank's batch in a
    data-parallel step (``parallel/distributed.py:rank_mean_denominator``)."""
    if mask is None:
        return loss.mean()
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / rank_mean_denominator(mask.sum()).clamp(
        min=1e-12)


def _visibility_mask(batch, min_visibility, shape):
    if min_visibility is None:
        return None
    vis = batch["visibility"] >= min_visibility            # (B, H, W)
    return vis[..., None].expand(shape)


@dataclasses.dataclass(frozen=True)
class BinarySegmentationLoss:
    """Focal loss on the ``bev`` logits, optionally restricted to pixels of
    visibility >= ``min_visibility``.  ``label_indices`` folds the label
    channels of each group with a max (reference ``losses.py:46-49``)."""

    label_indices: Optional[Tuple[Tuple[int, ...], ...]] = None
    min_visibility: Optional[int] = None
    alpha: float = -1.0
    gamma: float = 2.0

    def __call__(self, pred, batch):
        logits = pred["bev"] if isinstance(pred, dict) else pred
        label = batch["bev"].to(logits.dtype)            # (B, H, W, n)
        if self.label_indices is not None:
            label = torch.stack([label[..., list(idx)].amax(-1)
                                 for idx in self.label_indices], dim=-1)
        loss = sigmoid_focal_loss(logits, label, self.alpha, self.gamma)
        return _masked_mean(loss, _visibility_mask(
            batch, self.min_visibility, loss.shape))


@dataclasses.dataclass(frozen=True)
class CenterLoss:
    """Focal loss on the ``center`` logits against the centerness map,
    masked like :class:`BinarySegmentationLoss`."""

    min_visibility: Optional[int] = None
    alpha: float = -1.0
    gamma: float = 2.0

    def __call__(self, pred, batch):
        logits = pred["center"]
        label = batch["center"].to(logits.dtype)
        loss = sigmoid_focal_loss(logits, label, self.alpha, self.gamma)
        return _masked_mean(loss, _visibility_mask(
            batch, self.min_visibility, loss.shape))


@dataclasses.dataclass(frozen=True)
class MultipleLoss:
    """Weighted sum of named losses: (total, {name: unweighted value}); a
    name without a weight weighs 1."""

    losses: Tuple[Tuple[str, object], ...] = ()
    weights: Tuple[Tuple[str, float], ...] = ()

    def __call__(self, pred, batch):
        w = dict(self.weights)
        outputs = {name: fn(pred, batch) for name, fn in self.losses}
        total = sum(w.get(name, 1.0) * v for name, v in outputs.items())
        return total, outputs

from cobevt_tpu_torch.losses.detection_loss import PointPillarLoss, smooth_l1
from cobevt_tpu_torch.losses.seg_losses import (
    BinarySegmentationLoss,
    CenterLoss,
    MultipleLoss,
    VanillaSegLoss,
    sigmoid_focal_loss,
    weighted_cross_entropy,
)

__all__ = ["BinarySegmentationLoss", "CenterLoss", "MultipleLoss",
           "PointPillarLoss", "VanillaSegLoss", "sigmoid_focal_loss",
           "smooth_l1", "weighted_cross_entropy"]

from cobevt_tpu_torch.losses.seg_losses import (
    VanillaSegLoss,
    weighted_cross_entropy,
)

__all__ = ["VanillaSegLoss", "weighted_cross_entropy"]

from cobevt_tpu_torch.metrics.iou import (
    IoUState,
    confusion_counts,
    iou_compute,
    iou_update,
    mean_iou_reference,
    per_class_iou,
)

__all__ = ["IoUState", "confusion_counts", "iou_compute", "iou_update",
           "mean_iou_reference", "per_class_iou"]

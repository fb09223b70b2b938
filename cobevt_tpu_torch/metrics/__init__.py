from cobevt_tpu_torch.metrics.detection_ap import (
    accumulate_tp_fp,
    calculate_ap,
    new_result_stat,
    voc_ap,
)
from cobevt_tpu_torch.metrics.iou import (
    IoUState,
    confusion_counts,
    iou_compute,
    iou_update,
    mean_iou_reference,
    per_class_iou,
)

__all__ = ["IoUState", "accumulate_tp_fp", "calculate_ap",
           "confusion_counts", "iou_compute", "iou_update",
           "mean_iou_reference", "new_result_stat", "per_class_iou", "voc_ap"]

"""Ground-truth round-trip checks of the LiDAR post-processors.

Counterpart of ``cobevt_tpu/tools/debug_utils.py`` (reference
``tools/debug_utils.py:22``): ground-truth targets go back through the
matching decoder, and the original boxes must come back, which catches a
drift between the label and decoder conventions.
"""

from __future__ import annotations

import numpy as np


def check_anchor_roundtrip(postprocessor, gt_boxes: np.ndarray,
                           mask: np.ndarray, tol: float = 0.5) -> bool:
    """Encode GT -> anchor targets -> decode -> compare centers.

    `postprocessor` is a cobevt_tpu_torch.postprocess.VoxelPostprocessor.
    Returns True when every GT box is recovered within `tol` meters.
    """
    label = postprocessor.generate_label(gt_boxes, mask)
    H, W, A = label["pos_equal_one"].shape
    cls_logits = np.where(label["pos_equal_one"] > 0, 10.0, -10.0)
    # decode treats (H, W, A) cls + (H, W, A*7) reg
    corners, scores = postprocessor.decode(
        cls_logits.reshape(H, W, A), label["targets"])
    gt_valid = gt_boxes[mask == 1]
    if len(gt_valid) == 0:
        return len(corners) == 0
    centers = corners.mean(axis=1)[:, :2]
    ok = True
    for g in gt_valid:
        d = np.linalg.norm(centers - g[:2], axis=1).min() \
            if len(centers) else np.inf
        ok &= d < tol
    return bool(ok)


def check_pixor_roundtrip(postprocessor, gt_boxes: np.ndarray,
                          mask: np.ndarray, tol: float = 1.0) -> bool:
    """Same round trip for the PIXOR-style postprocessor."""
    label = postprocessor.generate_label(gt_boxes, mask)["label_map"]
    logits = np.where(label[..., 0] > 0, 10.0, -10.0)
    corners, _ = postprocessor.decode(logits, label[..., 1:])
    gt_valid = gt_boxes[mask == 1]
    if len(gt_valid) == 0:
        return len(corners) == 0
    centers = corners.mean(axis=1)
    ok = True
    for g in gt_valid:
        d = np.linalg.norm(centers - g[:2], axis=1).min() \
            if len(centers) else np.inf
        ok &= d < tol
    return bool(ok)

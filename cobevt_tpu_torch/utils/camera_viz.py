"""Camera-space box visualization.

Counterpart of ``cobevt_tpu/utils/camera_viz.py`` (reference
``opv2v/opencood/utils/camera_utils.py``: :143 ``draw_2d_bbx``, :186
``draw_3d_bbx`` and the projection chain), a numpy copy: 3D box corners
(``geometry/boxes.py:boxes_to_corners_3d``) are projected through the
camera pose and intrinsic into the image, then drawn as 2D hulls or 3D
wireframes with OpenCV, which is imported only when drawing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# 3D wireframe edges over the 8-corner layout of
# geometry/boxes.py:boxes_to_corners_3d
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7))


def project_to_camera(corners3d: np.ndarray, camera_to_world: np.ndarray,
                      intrinsic: np.ndarray):
    """(N, 8, 3) world corners -> (N, 8, 2) pixels + (N, 8) in-front mask.

    `camera_to_world` is the camera pose (as the OPV2V yaml provides);
    points are moved into camera coordinates with its inverse and mapped
    through K.  Follows the OPV2V camera axes (x forward, y right,
    z up -> image x = -y, image y = -z, depth = x)."""
    world_to_cam = np.linalg.inv(camera_to_world)
    N = corners3d.shape[0]
    hom = np.concatenate([corners3d, np.ones((N, 8, 1))], axis=-1)
    cam = np.einsum("ij,nkj->nki", world_to_cam, hom)[..., :3]
    # camera frame -> optical frame
    optical = np.stack([-cam[..., 1], -cam[..., 2], cam[..., 0]], -1)
    depth = optical[..., 2]
    in_front = depth > 0.1
    pix = np.einsum("ij,nkj->nki", np.asarray(intrinsic), optical)
    pix = pix[..., :2] / np.maximum(pix[..., 2:3], 1e-6)
    return pix, in_front


def draw_3d_boxes(image: np.ndarray, corners2d: np.ndarray,
                  valid: Optional[np.ndarray] = None,
                  color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """Draw projected 3D wireframes onto a (H, W, 3) uint8 image."""
    import cv2

    out = image.copy()
    for n in range(corners2d.shape[0]):
        if valid is not None and not valid[n].all():
            continue
        pts = np.round(corners2d[n]).astype(np.int32)
        for a, b in BOX_EDGES:
            cv2.line(out, tuple(pts[a]), tuple(pts[b]), color, thickness)
    return out


def draw_2d_boxes(image: np.ndarray, corners2d: np.ndarray,
                  valid: Optional[np.ndarray] = None,
                  color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Draw axis-aligned hulls of the projected corners."""
    import cv2

    out = image.copy()
    for n in range(corners2d.shape[0]):
        if valid is not None and not valid[n].any():
            continue
        x1, y1 = corners2d[n].min(0)
        x2, y2 = corners2d[n].max(0)
        cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)),
                      color, thickness)
    return out

"""Object ground truth from OPV2V annotations.

Counterpart of ``cobevt_tpu/data/objects.py`` (reference
``box_utils.py:395`` ``create_bbx``, ``:422`` ``project_world_objects`` and
``base_postprocessor.py:100`` ``generate_object_center``): merge every CAV's
world-frame vehicle annotations, project them into the reference LiDAR
frame, filter them by range and pad to (max_num, 7) with a mask.  numpy on
the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from cobevt_tpu_torch.geometry import boxes as box_ops
from cobevt_tpu_torch.geometry.transforms import x1_to_x2

GT_RANGE = (-140, -40, -3, 140, 40, 1)


def create_bbx(extent) -> np.ndarray:
    """(8, 3) corners from half-extents [l/2, w/2, h/2] in the object
    frame (same corner ordering as boxes_to_corners_3d)."""
    dims = 2.0 * np.asarray(extent, np.float64)
    return box_ops._CORNER_TEMPLATE_3D * dims


def project_world_objects(object_dict: Dict, lidar_pose,
                          lidar_range, order: str = "hwl") -> Dict:
    """World-frame vehicle dict -> {id: (1, 7) box in lidar frame}."""
    out = {}
    for object_id, content in object_dict.items():
        loc = content["location"]
        rot = content["angle"]
        center = content.get("center", [0, 0, 0])
        extent = content["extent"]
        pose = [loc[0] + center[0], loc[1] + center[1],
                loc[2] + center[2], rot[0], rot[1], rot[2]]
        obj2lidar = x1_to_x2(pose, lidar_pose)
        corners = create_bbx(extent)
        corners_lidar = box_ops.project_box3d(corners[None], obj2lidar)
        box = box_ops.corner_to_center(corners_lidar, order)
        keep = box_ops.mask_boxes_outside_range(box, lidar_range, order,
                                                min_num_corners=8)
        if keep.any():
            out[object_id] = box
    return out


def generate_object_center(cav_params_list: Sequence[Dict],
                           reference_lidar_pose, max_num: int = 100,
                           order: str = "hwl",
                           lidar_range=GT_RANGE
                           ) -> Tuple[np.ndarray, np.ndarray, List]:
    """Merge every CAV's annotations, project to the reference frame, and
    pad: returns (max_num, 7) boxes, (max_num,) mask, object id list."""
    merged: Dict = {}
    for params in cav_params_list:
        merged.update(params.get("vehicles", {}))
    projected = project_world_objects(merged, reference_lidar_pose,
                                      lidar_range, order)
    boxes = np.zeros((max_num, 7))
    mask = np.zeros(max_num)
    ids = []
    for i, (oid, box) in enumerate(projected.items()):
        if i >= max_num:
            break
        boxes[i] = box[0]
        mask[i] = 1
        ids.append(oid)
    return boxes, mask, ids

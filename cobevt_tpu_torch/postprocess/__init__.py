"""Host-side LiDAR post-processing: anchor targets and decoding
(``voxel_postprocessor``), the PIXOR-style BEV maps
(``lidar_bev_postprocessor``)."""

from cobevt_tpu_torch.postprocess.voxel_postprocessor import (
    VoxelPostprocessor,
    delta_to_boxes3d,
    generate_anchor_box,
)

__all__ = ["VoxelPostprocessor", "delta_to_boxes3d", "generate_anchor_box"]

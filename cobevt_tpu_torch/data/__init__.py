"""cobevt_tpu_torch.data: the OPV2V camera datasets, their loader and the
sample cache (counterpart of ``cobevt_tpu/data/__init__.py``)."""

from cobevt_tpu_torch.data.labels import decode_binary_maps, encode_binary_maps
from cobevt_tpu_torch.data.loader import DataLoader
from cobevt_tpu_torch.data.opv2v import (
    OPV2VCameraDataset,
    OPV2VScenarioDatabase,
    WildConfig,
    generate_bev_label,
    merge_static_labels,
    preprocess_camera_image,
)
from cobevt_tpu_torch.data.opv2v_late import OPV2VLateFusionDataset

# string dispatch mirroring the reference registry
# (opv2v/opencood/data_utils/datasets/__init__.py:5-18)
DATASET_REGISTRY = {
    "CamIntermediateFusionDataset": OPV2VCameraDataset,
    "CamLateFusionDataset": OPV2VLateFusionDataset,
}

GT_RANGE = (-140, -40, -3, 140, 40, 1)
CAMERA_GT_RANGE = (-50, -50, -3, 50, 50, 1)
COM_RANGE = 70.0


def build_dataset(hypes: dict, train: bool = True, db=None, **kwargs):
    """Build a dataset from a hypes dict (`fusion.core_method`)."""
    name = hypes["fusion"]["core_method"]
    if name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; "
                       f"available: {sorted(DATASET_REGISTRY)}")
    cls = DATASET_REGISTRY[name]
    if db is None:
        root = hypes["root_dir"] if train else hypes["validate_dir"]
        db = OPV2VScenarioDatabase(
            root, max_cav=hypes["train_params"]["max_cav"],
            shuffle_cavs=train)
    img_hw = (hypes["preprocess"]["args"]["resize_y"],
              hypes["preprocess"]["args"]["resize_x"])
    wild = (WildConfig(**hypes["wild_setting"])
            if "wild_setting" in hypes else WildConfig())
    return cls(db, image_hw=img_hw,
               visible=hypes["train_params"].get("visible", True),
               wild=wild, train=train, **kwargs)


__all__ = ["CAMERA_GT_RANGE", "COM_RANGE", "DATASET_REGISTRY", "DataLoader",
           "GT_RANGE", "OPV2VCameraDataset", "OPV2VLateFusionDataset",
           "OPV2VScenarioDatabase", "WildConfig", "build_dataset",
           "decode_binary_maps", "encode_binary_maps", "generate_bev_label",
           "merge_static_labels", "preprocess_camera_image"]

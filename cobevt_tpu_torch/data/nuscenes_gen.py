"""nuScenes generated-label dataset.

Counterpart of ``cobevt_tpu/data/nuscenes_gen.py`` (reference
``nuscenes/cross_view_transformer/data/transforms.py:100-187`` and
``data/nuscenes_dataset_generated.py:34``): one scene's JSON index of
samples, each with its camera files, intrinsics, extrinsics, BEV view and
pose, a bit-packed BEV label PNG (16-bit where more than 8 classes), a
visibility PNG and an aux ``.npz``, as ``data/nuscenes_labelgen.py:
save_scene_labels`` writes them.  A sample is a dict of numpy arrays: image
(n, h, w, 3) f32 in [0, 1] (uint8 with ``raw_uint8``), intrinsics,
extrinsics, view, bev (h, w, n_classes), visibility (h, w) uint8, center
(h, w, 1) from ``aux[..., 1]``, pose.

Cameras are resized to (h + top_crop, w) with PIL's bilinear filter, the
top ``top_crop`` rows cut and the intrinsics rescaled to match.  A PNG
camera is decoded by ``data/image_io.py``'s codec and resized by its
``resize_bilinear_u8`` on every machine (within 1 level of PIL).  A JPEG
camera goes through PIL as in the JAX package (``draft``, then
``BILINEAR``) and raises where PIL is not installed.  Labels are read
unchanged (``imread_unchanged``), never through a BGR read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from cobevt_tpu_torch.data.image_io import (
    imread_unchanged,
    read_png,
    resize_bilinear_u8,
)
from cobevt_tpu_torch.data.labels import decode_binary_maps

try:
    from PIL import Image
except ImportError:
    Image = None


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    h: int = 224
    w: int = 480
    top_crop: int = 46


def _resized_rgb(path: str, hw) -> np.ndarray:
    """The camera at ``path`` as (h, w, 3) RGB uint8 resized to ``hw`` with
    PIL's bilinear filter, and its size (W0, H0) before."""
    h, w = hw
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a camera PNG must be 8-bit")
        size = (img.shape[1], img.shape[0])
        return resize_bilinear_u8(img[..., 2::-1], hw), size
    if Image is None:
        raise RuntimeError(
            f"{path}: a JPEG camera needs PIL (Pillow), which is not "
            f"installed; the port decodes only PNG cameras without it")
    pil = Image.open(path)
    size = pil.size
    # JPEG draft mode: a DCT-domain downscale during decode to the smallest
    # power-of-two scale still >= the target, as the JAX loader does
    pil.draft("RGB", (w, h))
    pil = pil.resize((w, h), resample=Image.BILINEAR)
    arr = np.asarray(pil, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    return arr[..., :3], size


def load_image_with_intrinsics(path: str, intrinsic: np.ndarray,
                               cfg: ImageConfig, as_uint8: bool = False):
    """Resize to (h + top_crop, w), crop the top, rescale K (reference
    ``transforms.py:118-139``).  Returns ((h, w, 3) f32 in [0, 1], or uint8
    with ``as_uint8``, and the new K)."""
    h_resize, w_resize = cfg.h + cfg.top_crop, cfg.w
    rgb, (W0, H0) = _resized_rgb(path, (h_resize, w_resize))
    rgb = rgb[cfg.top_crop:]
    arr = rgb if as_uint8 else np.asarray(rgb, np.float32) / 255.0

    K = np.array(intrinsic, np.float32)
    K[0, 0] *= w_resize / W0
    K[0, 2] *= w_resize / W0
    K[1, 1] *= h_resize / H0
    K[1, 2] *= h_resize / H0
    K[1, 2] -= cfg.top_crop
    return arr, K


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class NuScenesGeneratedDataset:
    """One scene: ``labels_dir/<scene>.json`` written at label-generation
    time; camera paths resolve under ``dataset_dir``."""

    collate = staticmethod(collate)

    def __init__(self, scene_name: str, dataset_dir: str, labels_dir: str,
                 image_config: ImageConfig = ImageConfig(),
                 num_classes: int = 12, raw_uint8: bool = False):
        self.scene_name = scene_name
        self.dataset_dir = Path(dataset_dir)
        self.labels_dir = Path(labels_dir)
        self.image_config = image_config
        self.num_classes = num_classes
        self.raw_uint8 = raw_uint8
        with open(self.labels_dir / f"{scene_name}.json") as f:
            self.samples = json.load(f)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        scene_dir = self.labels_dir / s["scene"]
        images, intrinsics = [], []
        for path, K in zip(s["images"], s["intrinsics"]):
            img, K2 = load_image_with_intrinsics(
                str(self.dataset_dir / path), K, self.image_config,
                as_uint8=self.raw_uint8)
            images.append(img)
            intrinsics.append(K2)

        out = {
            "image": np.stack(images),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "extrinsics": np.array(s["extrinsics"], np.float32),
            "view": np.array(s["view"], np.float32),
        }
        if "bev" in s:
            packed = imread_unchanged(str(scene_dir / s["bev"]))
            out["bev"] = decode_binary_maps(
                packed, self.num_classes).astype(np.float32)
        if "visibility" in s:
            out["visibility"] = np.asarray(
                imread_unchanged(str(scene_dir / s["visibility"])), np.uint8)
        if "aux" in s:
            aux = np.load(scene_dir / s["aux"])["aux"]
            out["center"] = aux[..., 1:2].astype(np.float32)
        if "pose" in s:
            out["pose"] = np.array(s["pose"], np.float32)
        return out


class ConcatDataset:
    """Samples of several datasets end to end (reference
    ``data_module.py:7``)."""

    collate = staticmethod(collate)

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self.offsets[d])]


def concat_scene_datasets(split_scenes, dataset_dir, labels_dir,
                          image_config=ImageConfig(), num_classes=12,
                          raw_uint8: bool = False) -> ConcatDataset:
    """A ``ConcatDataset`` of the scenes of ``split_scenes`` that have an
    index under ``labels_dir`` (reference ``data_module.py:20``)."""
    return ConcatDataset(
        NuScenesGeneratedDataset(scene, dataset_dir, labels_dir,
                                 image_config, num_classes, raw_uint8)
        for scene in split_scenes
        if os.path.exists(os.path.join(labels_dir, f"{scene}.json")))

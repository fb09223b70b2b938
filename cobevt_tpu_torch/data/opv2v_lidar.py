"""OPV2V cooperative LiDAR dataset (intermediate fusion, detection).

Counterpart of ``cobevt_tpu/data/opv2v_lidar.py``: walk the OPV2V scenario
tree (``data/opv2v.py``), load each in-range CAV's .pcd, drop out-of-range
and ego points, augment the points (train, ``augment=True``), voxelize to
the padded pillar layout, and give the anchor targets of the merged ground
truth in the ego frame.  Samples are the JAX package's, key by key.

As in the JAX package, augmentation moves the points and not the boxes
(``DataAugmentor`` is called with no boxes), so the targets stay those of
the unaugmented scene.

Augmentation draws random numbers: ``draws_random`` says so, and
``plan(idx)`` makes a sample's YAML reads and draws, so ``data/loader.py``
draws in its own process, in batch order, and its workers decode
(``__getitem__`` takes the plan in place of the index).  For a CUDA
device the loader's batches are pinned, and ``train/loop.py:
batch_to_device`` copies them to the model without blocking the host.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from cobevt_tpu_torch.data.lidar_preprocess import (
    DataAugmentor,
    load_pcd,
    mask_ego_points,
    mask_points_by_range,
)
from cobevt_tpu_torch.data.objects import GT_RANGE, generate_object_center
from cobevt_tpu_torch.data.opv2v import (
    COM_RANGE,
    OPV2VScenarioDatabase,
    load_scenario_yaml,
)
from cobevt_tpu_torch.data.voxelize import voxelize_points
from cobevt_tpu_torch.geometry.transforms import x1_to_x2
from cobevt_tpu_torch.postprocess.voxel_postprocessor import (
    VoxelPostprocessor,
)


class OPV2VLidarDataset:
    def __init__(self, db: OPV2VScenarioDatabase,
                 postprocessor: VoxelPostprocessor,
                 voxel_size=(0.4, 0.4, 4.0),
                 lidar_range=(-70.4, -40, -3, 70.4, 40, 1),
                 max_voxels: int = 8000,
                 max_points_per_voxel: int = 32,
                 max_objects: int = 100,
                 augment: bool = False,
                 train: bool = True,
                 seed: int = 0):
        self.db = db
        self.post = postprocessor
        self.voxel_size = voxel_size
        self.lidar_range = lidar_range
        self.max_voxels = max_voxels
        self.max_ppv = max_points_per_voxel
        self.max_objects = max_objects
        self.train = train
        self.augmentor = DataAugmentor(seed=seed) if augment else None
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.db)

    @property
    def draws_random(self) -> bool:
        """Whether a sample draws random numbers (the augmentation of a
        train sample)."""
        return self.augmentor is not None and self.train

    def epoch_state(self):
        """Each scenario's CAV order, which ``db.reinitialize`` reshuffles
        between epochs (``data/loader.py`` gives its workers a new copy of
        the dataset when this changes)."""
        return tuple(tuple(scenario) for scenario in self.db.scenarios)

    def plan(self, idx: int):
        """Sample ``idx``'s YAML reads and random draws, made now: ``(idx,
        ego pose, cavs)``, each live CAV as ``(params, .pcd path, draws)``
        in slot order, ``draws`` the augmentor's numbers (None without
        augmentation)."""
        scenario, t_index = self.db.locate(idx)
        cav_ids = list(scenario.keys())
        ego_entries = scenario[cav_ids[0]]["entries"]
        ts = list(ego_entries.keys())[t_index]
        ego_pose = load_scenario_yaml(ego_entries[ts]["yaml"])["lidar_pose"]

        cavs = []
        for cav_id in cav_ids:
            entries = scenario[cav_id]["entries"]
            if ts not in entries or len(cavs) >= self.db.max_cav:
                continue
            params = load_scenario_yaml(entries[ts]["yaml"])
            pose = params["lidar_pose"]
            if math.hypot(pose[0] - ego_pose[0],
                          pose[1] - ego_pose[1]) > COM_RANGE:
                continue
            draws = self.augmentor.draw() if self.draws_random else None
            cavs.append((params, entries[ts]["lidar"], draws))
        return idx, ego_pose, cavs

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        """``key``: an index, or the index's ``plan``."""
        _, ego_pose, cavs = key if isinstance(key, tuple) else self.plan(key)

        L = self.db.max_cav
        N, P = self.max_voxels, self.max_ppv
        voxel_features = np.zeros((L, N, P, 4), np.float32)
        voxel_nums = np.zeros((L, N), np.int32)
        voxel_coords = np.zeros((L, N, 4), np.int32)
        voxel_mask = np.zeros((L, N), bool)
        tmat = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        agent_mask = np.zeros((L,), np.float32)

        for slot, (params, lidar_path, draws) in enumerate(cavs):
            points = self._load_points(lidar_path)
            points = mask_ego_points(
                mask_points_by_range(points, self.lidar_range))
            if draws is not None:
                _, points = self.augmentor(np.zeros((0, 7)), points, draws)
                points = mask_points_by_range(points, self.lidar_range)
            vox = voxelize_points(points, self.voxel_size,
                                  self.lidar_range, N, P)
            voxel_features[slot] = vox["voxel_features"]
            voxel_nums[slot] = vox["voxel_num_points"]
            voxel_coords[slot] = vox["voxel_coords"]
            voxel_mask[slot] = vox["voxel_mask"]
            tmat[slot] = x1_to_x2(params["lidar_pose"],
                                  ego_pose).astype(np.float32)
            agent_mask[slot] = 1.0

        # train filters by the detection range; eval keeps the wider GT
        # range (reference base_postprocessor.py:131-133)
        gt_range = self.lidar_range if self.train else GT_RANGE
        boxes, mask, _ = generate_object_center(
            [params for params, _, _ in cavs], ego_pose, self.max_objects,
            order=self.post.order, lidar_range=gt_range)
        label = self.post.generate_label(boxes, mask)

        return {
            "voxel_features": voxel_features,
            "voxel_num_points": voxel_nums,
            "voxel_coords": voxel_coords,
            "voxel_mask": voxel_mask.astype(np.float32),
            "transformation_matrix": tmat,
            "agent_mask": agent_mask,
            "object_bbx_center": boxes.astype(np.float32),
            "object_bbx_mask": mask.astype(np.float32),
            "pos_equal_one": label["pos_equal_one"].astype(np.float32),
            "neg_equal_one": label["neg_equal_one"].astype(np.float32),
            "targets": label["targets"].astype(np.float32),
        }

    def _load_points(self, path: str) -> np.ndarray:
        try:
            return load_pcd(path)
        except (FileNotFoundError, OSError, ValueError):
            return np.zeros((1, 4), np.float32)

    @staticmethod
    def collate(samples: List[Dict[str, np.ndarray]]):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

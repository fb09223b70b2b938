"""OPV2V late-fusion camera dataset (single-agent samples).

Counterpart of ``cobevt_tpu/data/opv2v_late.py``: `CamLateFusionDataset`
(reference opv2v/opencood/data_utils/datasets/camera_only/
late_fusion_dataset.py:16): at train time each sample is ONE randomly
chosen CAV with its own BEV labels (SinBEVT training); at test time every
in-range CAV becomes its own sample carrying its cav->ego transform so
predictions can be late-fused in ego space.

Label-choice quirk preserved (late_fusion_dataset.py:121-125): with
``visible=True`` the train-time dynamic label is `bev_visibility.png`
while test uses `bev_visibility_corp.png` (intermediate fusion always
uses the corp variant).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from cobevt_tpu_torch.data.opv2v import (
    COM_RANGE,
    OPV2VCameraDataset,
    OPV2VScenarioDatabase,
    generate_bev_label,
    load_scenario_yaml,
    merge_static_labels,
    preprocess_camera_image,
)
from cobevt_tpu_torch.geometry.transforms import x1_to_x2


class OPV2VLateFusionDataset(OPV2VCameraDataset):
    """Train: one random CAV per index.  Test: `test_samples()` yields
    (cav_id, sample) for every in-range CAV."""

    @property
    def draws_random(self) -> bool:
        """Whether a sample draws random numbers (the train-time CAV)."""
        return self.train

    def plan(self, idx: int):
        """``(idx, cav_id)``: the CAV of sample ``idx``, drawn now from
        ``self.rng`` at train time (see ``OPV2VCameraDataset.plan``)."""
        cav_ids = list(self.db.locate(idx)[0].keys())
        if self.train:
            return idx, cav_ids[self.rng.randint(len(cav_ids))]
        return idx, cav_ids[0]

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        """``key``: an index, or the index's ``plan``."""
        idx, cav_id = key if isinstance(key, tuple) else self.plan(key)
        scenario, t_index = self.db.locate(idx)
        return self._single_cav_sample(scenario, cav_id, t_index,
                                       np.eye(4, dtype=np.float32))

    def test_samples(self, idx: int) -> Dict[str, Dict[str, np.ndarray]]:
        """All in-range CAVs at one timestamp with cav->ego transforms."""
        scenario, t_index = self.db.locate(idx)
        cav_ids = list(scenario.keys())
        ego_entries = scenario[cav_ids[0]]["entries"]
        ts = list(ego_entries.keys())[t_index]
        ego_pose = load_scenario_yaml(
            ego_entries[ts]["yaml"])["lidar_pose"]

        out = {}
        for cav_id in cav_ids:
            entries = scenario[cav_id]["entries"]
            if ts not in entries:
                continue
            pose = load_scenario_yaml(entries[ts]["yaml"])["lidar_pose"]
            if math.hypot(pose[0] - ego_pose[0],
                          pose[1] - ego_pose[1]) > COM_RANGE:
                continue
            tmat = x1_to_x2(pose, ego_pose).astype(np.float32)
            out[cav_id] = self._single_cav_sample(scenario, cav_id,
                                                  t_index, tmat)
        return out

    def _single_cav_sample(self, scenario, cav_id, t_index, tmat):
        entries = scenario[cav_id]["entries"]
        ts = list(entries.keys())[t_index]
        params = load_scenario_yaml(entries[ts]["yaml"])
        pose = params["lidar_pose"]

        M = OPV2VScenarioDatabase.CAMERA_COUNT
        H, W = self.image_hw
        inputs = np.zeros((1, M, H, W, 3), np.float32)
        intrinsic = np.tile(np.eye(3, dtype=np.float32), (1, M, 1, 1))
        extrinsic = np.tile(np.eye(4, dtype=np.float32), (1, M, 1, 1))
        for m in range(M):
            cam = params[f"camera{m}"]
            img = self._read_image(entries[ts]["cameras"][m])
            inputs[0, m] = preprocess_camera_image(img, self.image_hw)
            intrinsic[0, m] = np.asarray(cam["intrinsic"], np.float32)
            extrinsic[0, m] = x1_to_x2(cam["cords"],
                                       pose).astype(np.float32)

        # label-choice quirk (see module docstring)
        if self.visible:
            dyn_key = ("bev_visibility.png" if self.train
                       else "bev_visibility_corp.png")
        else:
            dyn_key = "bev_dynamic.png"
        dynamic = generate_bev_label(
            self._read_label(entries[ts], dyn_key))
        road = generate_bev_label(
            self._read_label(entries[ts], "bev_static.png"))
        lane = generate_bev_label(
            self._read_label(entries[ts], "bev_lane.png"))

        return {
            "inputs": inputs,
            "intrinsic": intrinsic,
            "extrinsic": extrinsic,
            "transformation_matrix": tmat[None],
            "agent_mask": np.ones((1,), np.float32),
            "gt_dynamic": dynamic[None].astype(np.int32),
            "gt_static": merge_static_labels(
                road, lane)[None].astype(np.int32),
        }

"""OPV2V cooperative camera dataset frontend.

Counterpart of ``cobevt_tpu/data/opv2v.py`` (reference
``opv2v/opencood/data_utils/``): the scenario/CAV/timestamp directory walk
with per-epoch CAV shuffling, the "wild settings" (communication delay and
localization noise), the camera parameter reform, RGB preprocessing, BEV
labels from the dataset's label PNGs, the communication-range filter and the
per-sample agent stacking of ``CamIntermediateFusionDataset``.  Plain numpy
on the host, sample for sample the JAX package's arrays: every sample comes
out padded to max_cav with an agent mask.

Files are read through ``data/image_io.py`` (OpenCV where installed, else a
PNG codec) and ``configs/hypes.py:read_yaml`` (PyYAML where installed, else
JSON).  A camera or label file that is absent reads as zeros, as in the JAX
package; a file that exists but cannot be decoded raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cobevt_tpu_torch.configs.hypes import read_yaml
from cobevt_tpu_torch.data.image_io import imread
from cobevt_tpu_torch.geometry.transforms import x1_to_x2

COM_RANGE = 70.0  # meters (reference datasets/__init__.py:15)

try:
    import cv2
except ImportError:
    cv2 = None


# ---------------------------------------------------------------------------
# wild settings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WildConfig:
    """Communication delay + localization noise simulation."""

    async_flag: bool = False
    async_mode: str = "sim"        # 'sim' (fixed) or 'real' (stochastic)
    async_overhead: float = 0.0    # ms in real mode; frames in sim mode
    data_size: float = 1.06        # MB
    transmission_speed: float = 27.0  # Mbps
    backbone_delay: float = 0.0    # ms
    loc_err_flag: bool = False
    xyz_noise_std: float = 0.0
    ryp_noise_std: float = 0.0
    seed: int = 20

    def time_delay_frames(self, is_ego: bool, rng: np.random.RandomState):
        """Delay in 100ms frames (reference basedataset.py:401-429)."""
        if is_ego or not self.async_flag:
            return 0
        if self.async_mode == "real":
            overhead = rng.uniform(0, self.async_overhead)
            tc = self.data_size / self.transmission_speed * 1000
            delay_ms = overhead + tc + self.backbone_delay
            return int(delay_ms) // 100
        return int(abs(self.async_overhead)) // 100

    def noisy_pose(self, pose, rng: np.random.RandomState):
        """Gaussian noise on x/y/z and yaw (reference basedataset.py:431:
        roll/pitch untouched; note the reference re-seeds a fixed seed —
        we take an explicit RNG for reproducibility without the global
        side effect)."""
        if not self.loc_err_flag:
            return list(pose)
        xyz = rng.normal(0, self.xyz_noise_std, 3)
        ryp = rng.normal(0, self.ryp_noise_std, 3)
        return [pose[0] + xyz[0], pose[1] + xyz[1], pose[2] + xyz[2],
                pose[3], pose[4] + ryp[1], pose[5]]


# ---------------------------------------------------------------------------
# scenario database
# ---------------------------------------------------------------------------

def load_scenario_yaml(path: str) -> dict:
    """One per-timestamp file (libyaml's safe loader where built)."""
    return read_yaml(path)


class OPV2VScenarioDatabase:
    """Walks `root/scenario/cav_id/timestamp.{yaml,png,...}` into an index.

    Ego is the first CAV (after optional shuffling); RSUs (negative ids)
    sort to the end so they are never ego."""

    CAMERA_COUNT = 4

    def __init__(self, root_dir: str, max_cav: int = 5,
                 shuffle_cavs: bool = False,
                 extra_extensions: Sequence[str] = (
                     "bev_dynamic.png", "bev_static.png", "bev_lane.png",
                     "bev_visibility.png", "bev_visibility_corp.png"),
                 rng: Optional[random.Random] = None):
        self.root_dir = root_dir
        self.max_cav = max_cav
        self.shuffle_cavs = shuffle_cavs
        self.extra_extensions = tuple(extra_extensions)
        self._rng = rng or random.Random(0)
        self.reinitialize()

    def reinitialize(self):
        self.scenarios: List[OrderedDict] = []
        self.len_record: List[int] = []
        folders = sorted(os.path.join(self.root_dir, d)
                         for d in os.listdir(self.root_dir)
                         if os.path.isdir(os.path.join(self.root_dir, d)))
        total = 0
        for folder in folders:
            cav_list = [d for d in os.listdir(folder)
                        if os.path.isdir(os.path.join(folder, d))]
            if self.shuffle_cavs:
                self._rng.shuffle(cav_list)
            else:
                cav_list = sorted(cav_list)
            if cav_list and int(cav_list[0]) < 0:
                cav_list = cav_list[1:] + [cav_list[0]]

            scenario = OrderedDict()
            n_timestamps = 0
            for j, cav_id in enumerate(cav_list):
                if j >= self.max_cav:
                    break
                cav_path = os.path.join(folder, cav_id)
                stamps = sorted(
                    f[:-5] for f in os.listdir(cav_path)
                    if f.endswith(".yaml") and "additional" not in f)
                entries = OrderedDict()
                for ts in stamps:
                    rec = {"yaml": os.path.join(cav_path, f"{ts}.yaml"),
                           "lidar": os.path.join(cav_path, f"{ts}.pcd"),
                           "cameras": [os.path.join(
                               cav_path, f"{ts}_camera{k}.png")
                               for k in range(self.CAMERA_COUNT)]}
                    for ext in self.extra_extensions:
                        rec[ext] = os.path.join(cav_path, f"{ts}_{ext}")
                    entries[ts] = rec
                scenario[cav_id] = {"entries": entries, "ego": j == 0}
                if j == 0:
                    n_timestamps = len(stamps)
            self.scenarios.append(scenario)
            total += n_timestamps
            self.len_record.append(total)

    def __len__(self):
        return self.len_record[-1] if self.len_record else 0

    def locate(self, idx: int) -> Tuple[OrderedDict, int]:
        prev = 0
        for i, upto in enumerate(self.len_record):
            if idx < upto:
                return self.scenarios[i], idx - prev
            prev = upto
        raise IndexError(idx)


# ---------------------------------------------------------------------------
# preprocessing / labels
# ---------------------------------------------------------------------------

def resize_rgb_uint8(img: np.ndarray, resize_hw: Tuple[int, int],
                     bgr2rgb: bool = True) -> np.ndarray:
    """uint8 (H, W, 3) BGR -> resized uint8 RGB (h, w, 3)."""
    if bgr2rgb:
        img = img[..., ::-1]
    if cv2 is not None:
        img = cv2.resize(img, (resize_hw[1], resize_hw[0]))
    else:  # nearest fallback
        ys = (np.arange(resize_hw[0]) * img.shape[0] //
              resize_hw[0]).astype(int)
        xs = (np.arange(resize_hw[1]) * img.shape[1] //
              resize_hw[1]).astype(int)
        img = img[ys][:, xs]
    return np.ascontiguousarray(img)


def preprocess_camera_image(img: np.ndarray, resize_hw: Tuple[int, int],
                            mean=(0.485, 0.456, 0.406),
                            std=(0.229, 0.224, 0.225),
                            bgr2rgb: bool = True) -> np.ndarray:
    """uint8 (H, W, 3) BGR -> float32 normalized (h, w, 3)."""
    img = resize_rgb_uint8(img, resize_hw, bgr2rgb)
    img = img.astype(np.float32) / 255.0
    return ((img - np.asarray(mean, np.float32)) /
            np.asarray(std, np.float32)).astype(np.float32)


def generate_bev_label(bev_map: np.ndarray) -> np.ndarray:
    """RGB/BGR label PNG -> binary {0,1} float map."""
    if bev_map.ndim == 3:
        # BGR2GRAY weights (cv2): 0.114 B + 0.587 G + 0.299 R
        gray = (0.114 * bev_map[..., 0] + 0.587 * bev_map[..., 1] +
                0.299 * bev_map[..., 2])
    else:
        gray = bev_map
    return (gray > 0).astype(np.float32)


def merge_static_labels(road: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """road -> 1, lane -> 2, background -> 0."""
    merged = np.zeros_like(road)
    merged[road == 1] = 1
    merged[lane == 1] = 2
    return merged


# ---------------------------------------------------------------------------
# cooperative camera dataset
# ---------------------------------------------------------------------------

class OPV2VCameraDataset:
    """Cooperative (intermediate-fusion) camera dataset, padded layout.

    One sample: all CAVs within COM_RANGE of ego at one timestamp, with
    per-agent 4-camera stacks, camera->ego extrinsics, agent->ego SE(3),
    pairwise transforms, and the ego's dynamic/static BEV labels.
    """

    def __init__(self, db: OPV2VScenarioDatabase,
                 image_hw: Tuple[int, int] = (512, 512),
                 bev_hw: Tuple[int, int] = (256, 256),
                 visible: bool = True,
                 wild: WildConfig = WildConfig(),
                 train: bool = True,
                 seed: int = 0,
                 normalize: bool = True):
        """``normalize=False`` emits resized uint8 RGB in ``inputs``
        instead of ImageNet-normalized f32 — the models rescale on
        device (nn/layers.py:images_from_uint8), which quarters host
        float work, sample RAM, and host->device transfer; numerics are
        identical to the f32 contract (pinned by
        tests/test_data_pipeline.py)."""
        self.db = db
        self.image_hw = image_hw
        self.bev_hw = bev_hw
        self.visible = visible
        self.wild = wild
        self.train = train
        self.normalize = normalize
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.db)

    def _read_image(self, path):
        if os.path.exists(path):
            return imread(path)
        # tolerate missing files (e.g. tests with partial fixtures)
        return np.zeros((self.image_hw[0], self.image_hw[1], 3), np.uint8)

    @property
    def draws_random(self) -> bool:
        """Whether a sample draws random numbers (the wild settings' delay
        and pose noise)."""
        w = self.wild
        return (w.async_flag and w.async_mode == "real") or w.loc_err_flag

    def plan(self, idx: int):
        """Sample ``idx``'s YAML reads and every random number it draws,
        made now from ``self.rng``: ``(idx, ego params, cavs)``, each live
        CAV as ``(params, observed entry, observed pose)`` in slot order.
        ``__getitem__`` takes a plan in place of an index, so a loader draws
        in its own process, in batch order, and decodes in workers."""
        scenario, t_index = self.db.locate(idx)
        cav_ids = list(scenario.keys())
        ego_entries = scenario[cav_ids[0]]["entries"]
        stamps = list(ego_entries.keys())
        ts = stamps[t_index]

        ego_params = load_scenario_yaml(ego_entries[ts]["yaml"])
        ego_lidar_pose = ego_params["lidar_pose"]

        cavs = []
        for cav_id in cav_ids:
            cav = scenario[cav_id]
            entries = cav["entries"]
            if ts not in entries:
                continue
            params = load_scenario_yaml(entries[ts]["yaml"])
            pose = params["lidar_pose"]
            dist = math.hypot(pose[0] - ego_lidar_pose[0],
                              pose[1] - ego_lidar_pose[1])
            if dist > COM_RANGE or len(cavs) >= self.db.max_cav:
                continue

            # wild settings: images observed at the delayed timestamp,
            # camera parameters at the current one, agent->ego transform
            # from the delayed (possibly noisy) pose to the current ego
            # pose (reference basedataset.py:256-281 + reform_camera_param
            # :456, whose delay handling is current-timestamp only)
            delay = self.wild.time_delay_frames(cav["ego"], self.rng)
            delay = min(delay, t_index)
            ts_delay = stamps[t_index - delay]
            obs = entries.get(ts_delay, entries[ts])
            obs_params = (params if delay == 0
                          else load_scenario_yaml(obs["yaml"]))
            cav_pose = obs_params["lidar_pose"]
            if not cav["ego"]:
                cav_pose = self.wild.noisy_pose(cav_pose, self.rng)
            cavs.append((params, obs, cav_pose))
        return idx, ego_params, cavs

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        """``key``: an index, or the index's ``plan``."""
        idx, ego_params, cavs = (key if isinstance(key, tuple)
                                 else self.plan(key))
        scenario, t_index = self.db.locate(idx)
        ego_entries = scenario[next(iter(scenario))]["entries"]
        ts = list(ego_entries.keys())[t_index]
        ego_lidar_pose = ego_params["lidar_pose"]
        ego_pose = ego_params.get("true_ego_pos", ego_lidar_pose)

        L = self.db.max_cav
        M = OPV2VScenarioDatabase.CAMERA_COUNT
        H, W = self.image_hw
        inputs = np.zeros((L, M, H, W, 3),
                          np.float32 if self.normalize else np.uint8)
        intrinsic = np.tile(np.eye(3, dtype=np.float32), (L, M, 1, 1))
        extrinsic = np.tile(np.eye(4, dtype=np.float32), (L, M, 1, 1))
        tmat = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        pairwise = np.tile(np.eye(4, dtype=np.float32), (L, L, 1, 1))
        agent_mask = np.zeros((L,), np.float32)

        cav_to_ego_mats = []
        for slot, (params, obs, cav_pose) in enumerate(cavs):
            t_cav_to_ego = x1_to_x2(cav_pose, ego_lidar_pose)
            for m in range(M):
                cam = params[f"camera{m}"]
                img = self._read_image(obs["cameras"][m])
                inputs[slot, m] = (
                    preprocess_camera_image(img, self.image_hw)
                    if self.normalize
                    else resize_rgb_uint8(img, self.image_hw))
                intrinsic[slot, m] = np.asarray(cam["intrinsic"],
                                                np.float32)
                extrinsic[slot, m] = x1_to_x2(cam["cords"],
                                              ego_pose).astype(np.float32)

            tmat[slot] = t_cav_to_ego.astype(np.float32)
            agent_mask[slot] = 1.0
            cav_to_ego_mats.append(t_cav_to_ego)

        n = len(cav_to_ego_mats)
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                pairwise[i, j] = (
                    np.linalg.inv(cav_to_ego_mats[j]) @
                    cav_to_ego_mats[i]).astype(np.float32)

        # ego ground truth
        dyn_key = ("bev_visibility_corp.png" if self.visible
                   else "bev_dynamic.png")
        dynamic = generate_bev_label(self._read_label(ego_entries[ts],
                                                      dyn_key))
        road = generate_bev_label(self._read_label(ego_entries[ts],
                                                   "bev_static.png"))
        lane = generate_bev_label(self._read_label(ego_entries[ts],
                                                   "bev_lane.png"))
        static = merge_static_labels(road, lane)

        return {
            "inputs": inputs,
            "intrinsic": intrinsic,
            "extrinsic": extrinsic,
            "transformation_matrix": tmat,
            "pairwise_t_matrix": pairwise,
            "agent_mask": agent_mask,
            "gt_dynamic": dynamic[None].astype(np.int32),
            "gt_static": static[None].astype(np.int32),
        }

    def _read_label(self, record, key):
        path = record.get(key)
        if path and os.path.exists(path):
            return imread(path)
        return np.zeros((self.bev_hw[0], self.bev_hw[1], 3), np.uint8)

    @staticmethod
    def collate(samples: List[Dict[str, np.ndarray]]):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

"""LiDAR host-side preprocessing: pcd IO, BEV occupancy grids,
augmentations.

Counterpart of ``cobevt_tpu/data/lidar_preprocess.py`` (reference
``BevPreprocessor``, ``pcd_utils.py`` and the ``DataAugmentor`` of
``data_utils/augmentor/``), numpy on the host: a self-contained .pcd
parser (ASCII and binary) and writer, range and ego masks, shuffle and
downsample, the BEV occupancy grid, and the world flips, rotation and
scaling applied jointly to points and boxes.

``DataAugmentor.draw`` makes one call's random numbers ahead of the call, in
the order ``__call__`` draws them, and ``__call__(boxes, points, draws)``
applies them: a loader draws in its own process, in batch order, and its
workers apply (``data/opv2v_lidar.py``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# pcd IO
# ---------------------------------------------------------------------------

def load_pcd(path: str) -> np.ndarray:
    """Parse a .pcd file (ascii or binary) into (N, 4) [x y z intensity]."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z intensity").split()
        sizes = [int(s) for s in header.get(
            "SIZE", "4 4 4 4").split()]
        types = header.get("TYPE", "F F F F").split()
        count = int(header.get("POINTS",
                               header.get("WIDTH", "0")))
        fmt = {"F4": "f4", "F8": "f8", "U1": "u1", "U2": "u2",
               "U4": "u4", "I1": "i1", "I2": "i2", "I4": "i4"}
        dtype = np.dtype([(name, fmt[f"{t}{s}"]) for name, t, s in
                          zip(fields, types, sizes)])
        if header["DATA"].startswith("ascii"):
            raw = np.loadtxt(f, dtype=np.float64, max_rows=count)
            data = {name: raw[:, i] for i, name in enumerate(fields)}
        else:
            arr = np.frombuffer(f.read(dtype.itemsize * count),
                                dtype=dtype, count=count)
            data = {name: arr[name].astype(np.float64)
                    for name in fields}
    cols = [data.get(k, np.zeros(count)) for k in
            ("x", "y", "z", "intensity")]
    return np.stack(cols, axis=-1).astype(np.float32)


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write (N, 4) [x y z intensity] f32 points as a .pcd file that
    :func:`load_pcd` reads: ``DATA binary`` (little-endian f32 records) or
    ``DATA ascii`` (one point a line)."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 4)
    header = ("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(pts)}\n"
              f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(pts.astype("<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.9g")


def mask_points_by_range(points: np.ndarray, limit_range) -> np.ndarray:
    lr = np.asarray(limit_range)
    keep = np.all((points[:, :3] >= lr[:3]) & (points[:, :3] <= lr[3:]),
                  axis=1)
    return points[keep]


def mask_ego_points(points: np.ndarray,
                    ego_range=(-1.95, -1.1, 2.95, 1.1)) -> np.ndarray:
    """Remove the ego vehicle's own returns (reference pcd_utils.py)."""
    x1, y1, x2, y2 = ego_range
    inside = ((points[:, 0] >= x1) & (points[:, 0] <= x2) &
              (points[:, 1] >= y1) & (points[:, 1] <= y2))
    return points[~inside]


def shuffle_points(points: np.ndarray,
                   rng: Optional[np.random.RandomState] = None):
    rng = rng or np.random
    idx = rng.permutation(points.shape[0])
    return points[idx]


def downsample_points(points: np.ndarray, num: int,
                      rng: Optional[np.random.RandomState] = None):
    """Random sample to exactly `num` points (pad by resampling)."""
    rng = rng or np.random
    n = points.shape[0]
    if n >= num:
        idx = rng.choice(n, num, replace=False)
    else:
        idx = np.concatenate([np.arange(n),
                              rng.choice(n, num - n, replace=True)])
    return points[idx]


# ---------------------------------------------------------------------------
# BEV occupancy grid
# ---------------------------------------------------------------------------

def points_to_bev(points: np.ndarray, geometry: Dict) -> np.ndarray:
    """(N, 4) points -> (H, W, D+1) occupancy + mean-intensity grid.

    geometry: dict with L1/W1/H1, res, input_shape (as produced by
    cobevt_tpu_torch.configs.hypes.load_bev_params).  Channel layout matches
    the reference (last channel = mean intensity)."""
    shape = tuple(geometry["input_shape"])
    bev = np.zeros(shape, np.float32)
    counts = np.zeros(shape[:2], np.int64)
    origin = np.array([geometry["L1"], geometry["W1"], geometry["H1"]])
    idx = ((points[:, :3] - origin) / geometry["res"]).astype(np.int64)
    keep = np.all((idx >= 0) & (idx < np.array(shape) - np.array(
        [0, 0, 1])), axis=1)
    idx = idx[keep]
    pts = points[keep]
    bev[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
    np.add.at(bev, (idx[:, 0], idx[:, 1],
                    np.full(len(idx), shape[2] - 1)), pts[:, 3])
    np.add.at(counts, (idx[:, 0], idx[:, 1]), 1)
    nz = counts > 0
    bev[nz, -1] /= counts[nz]
    return bev


# ---------------------------------------------------------------------------
# augmentations (points + boxes jointly)
# ---------------------------------------------------------------------------

def random_flip_along_x(boxes, points, rng):
    if rng.rand() < 0.5:
        boxes = boxes.copy()
        points = points.copy()
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        points[:, 1] = -points[:, 1]
    return boxes, points


def random_flip_along_y(boxes, points, rng):
    if rng.rand() < 0.5:
        boxes = boxes.copy()
        points = points.copy()
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -(boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
    return boxes, points


def global_rotation(boxes, points, rot_range, rng):
    angle = rng.uniform(rot_range[0], rot_range[1])
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    points = points.copy()
    boxes = boxes.copy()
    points[:, :2] = points[:, :2] @ R.T
    boxes[:, :2] = boxes[:, :2] @ R.T
    boxes[:, 6] += angle
    return boxes, points


def global_scaling(boxes, points, scale_range, rng):
    s = rng.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    boxes = boxes.copy()
    points[:, :3] *= s
    boxes[:, :6] *= s
    return boxes, points


class _Replay:
    """Hands out drawn numbers in place of a ``RandomState``'s ``rand`` and
    ``uniform`` calls."""

    def __init__(self, values):
        self._values = iter(values)

    def rand(self):
        return next(self._values)

    def uniform(self, low, high):
        return next(self._values)


class DataAugmentor:
    """Configurable augmentation chain (reference data_augmentor.py:11)."""

    def __init__(self, config=None, seed: int = 0):
        self.config = config or [
            {"name": "random_world_flip", "along_axis_list": ["x"]},
            {"name": "random_world_rotation",
             "world_rot_angle": [-0.78539816, 0.78539816]},
            {"name": "random_world_scaling",
             "world_scale_range": [0.95, 1.05]},
        ]
        self.rng = np.random.RandomState(seed)

    def draw(self):
        """One call's random numbers from ``self.rng``, in the order the
        chain draws them: a ``rand()`` per flip axis, a ``uniform`` for the
        rotation and one for the scaling."""
        draws = []
        for cfg in self.config:
            if cfg["name"] == "random_world_flip":
                draws += [self.rng.rand() for _ in cfg["along_axis_list"]]
            elif cfg["name"] == "random_world_rotation":
                draws.append(self.rng.uniform(*cfg["world_rot_angle"][:2]))
            elif cfg["name"] == "random_world_scaling":
                draws.append(self.rng.uniform(
                    *cfg["world_scale_range"][:2]))
        return draws

    def __call__(self, boxes, points, draws=None):
        """Augment ``boxes`` and ``points`` jointly with ``draws`` (from
        :meth:`draw`), or with numbers drawn now."""
        rng = _Replay(self.draw() if draws is None else draws)
        for cfg in self.config:
            if cfg["name"] == "random_world_flip":
                for axis in cfg["along_axis_list"]:
                    fn = (random_flip_along_x if axis == "x"
                          else random_flip_along_y)
                    boxes, points = fn(boxes, points, rng)
            elif cfg["name"] == "random_world_rotation":
                boxes, points = global_rotation(
                    boxes, points, cfg["world_rot_angle"], rng)
            elif cfg["name"] == "random_world_scaling":
                boxes, points = global_scaling(
                    boxes, points, cfg["world_scale_range"], rng)
        return boxes, points

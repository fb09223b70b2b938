"""A synthetic OPV2V LiDAR scenario tree, drawn like a spinning sensor.

Writes one scenario in the OPV2V on-disk layout (``scenario_0/<cav>/<ts>.
{yaml,pcd}``) for the LiDAR dataset (``data/opv2v_lidar.py``): CAVs inside
the communication range, each timestamp's JSON-text YAML with the CAV's
``lidar_pose`` and the world-frame vehicles around it, and a point cloud a
CAV and timestamp.  A cloud is ray-cast from a 64-beam sensor spinning at
``LIDAR_HEIGHT`` above a flat ground: the beams' returns on the ground
plane and on the vehicles' box faces, each up to ``MAX_RANGE``, so the
density falls with range as a real sensor's does.  Vehicles stand on the
ground, apart from each other and from the CAVs, all inside the detection
range of the ego (the first CAV) at every timestamp.  Host only, numpy;
``chip_smoke.py`` phase 17 writes its scenario with
:func:`write_lidar_scenario`.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

LIDAR_HEIGHT = 1.9                       # meters above the ground
MAX_RANGE = 120.0
BEAM_ELEVATIONS = np.radians(np.linspace(-24.8, 2.0, 64))
# the CAVs' poses at the first timestamp (x, y, yaw in degrees); each moves
# 1 m along its heading a timestamp
CAV_POSES = ((0.0, 0.0, 0.0), (18.0, 3.5, 0.0), (-22.0, -3.5, 180.0),
             (38.0, 7.0, 5.0), (-40.0, 0.5, -3.0))
# where vehicles may stand in the ego's first frame (x1, y1, x2, y2)
VEHICLE_AREA = (-55.0, -30.0, 58.0, 30.0)


def spinning_lidar_cloud(boxes: np.ndarray, n_azimuth: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """(N, 4) [x y z intensity] f32 returns in the sensor frame of a 64-beam
    spinning sensor, ``n_azimuth`` rays a beam, against the ground plane
    ``LIDAR_HEIGHT`` below and ``boxes`` ((M, 7) hwl-order boxes in the
    sensor frame, yaw only); rays with no return within ``MAX_RANGE`` are
    dropped."""
    az = (np.arange(n_azimuth) / n_azimuth * 2 * np.pi)[None, :] + \
        rng.uniform(0, 2 * np.pi / n_azimuth, (len(BEAM_ELEVATIONS), 1))
    el = BEAM_ELEVATIONS[:, None]
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.broadcast_to(np.sin(el), az.shape)], -1).reshape(-1, 3)
    az = np.broadcast_to(az, el.shape[:1] + az.shape[1:]).reshape(-1)
    t = np.full(len(d), np.inf)
    down = d[:, 2] < 0
    t[down] = -LIDAR_HEIGHT / d[down, 2]
    hit_box = np.zeros(len(d), bool)
    for box in np.asarray(boxes, np.float64):
        # only the rays within the box's angular extent, seen from the
        # sensor (outside it), can hit it
        r, radius = np.hypot(box[0], box[1]), np.hypot(box[4], box[5]) / 2
        if r <= radius:
            continue
        off = (az - np.arctan2(box[1], box[0]) + np.pi) % (2 * np.pi) - np.pi
        rays = np.nonzero(np.abs(off) <= np.arcsin(radius / r) + 1e-3)[0]
        c, s = np.cos(box[6]), np.sin(box[6])
        # the ray in the box frame: origin -R^T center, direction R^T d
        o = np.array([-(c * box[0] + s * box[1]), s * box[0] - c * box[1],
                      -box[2]])
        dr = d[rays]
        db = np.stack([c * dr[:, 0] + s * dr[:, 1],
                       -s * dr[:, 0] + c * dr[:, 1], dr[:, 2]], -1)
        half = np.array([box[5], box[4], box[3]]) / 2      # l, w, h
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half - o) / db
            t2 = (half - o) / db
        near = np.nanmax(np.minimum(t1, t2), axis=1)
        far = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (near <= far) & (near > 0) & (near < t[rays])
        t[rays[hit]] = near[hit]
        hit_box[rays[hit]] = True
    keep = t < MAX_RANGE
    t = t[keep] + rng.normal(0, 0.02, keep.sum())
    xyz = d[keep] * t[:, None]
    intensity = np.where(hit_box[keep], rng.uniform(0.5, 0.9, keep.sum()),
                         rng.uniform(0.05, 0.3, keep.sum()))
    return np.column_stack([xyz, intensity]).astype(np.float32)


def _place_vehicles(n: int, rng: np.random.RandomState):
    """``n`` world-frame vehicles as the OPV2V YAML holds them, apart from
    each other and from the CAVs' paths."""
    taken = [(x + k * np.cos(np.radians(yaw)), y + k * np.sin(np.radians(
        yaw))) for x, y, yaw in CAV_POSES for k in range(4)]
    vehicles = {}
    x1, y1, x2, y2 = VEHICLE_AREA
    while len(vehicles) < n:
        x, y = rng.uniform(x1, x2), rng.uniform(y1, y2)
        if min(np.hypot(x - a, y - b) for a, b in taken) < 7.0:
            continue
        taken.append((x, y))
        extent = [float(rng.uniform(1.9, 2.4)),
                  float(rng.uniform(0.85, 1.0)),
                  float(rng.uniform(0.7, 0.85))]
        vehicles[str(1000 + len(vehicles))] = {
            "location": [float(x), float(y), extent[2]],
            "center": [0.0, 0.0, 0.0],
            "angle": [0.0, float(rng.uniform(-180, 180)), 0.0],
            "extent": extent}
    return vehicles


def write_lidar_scenario(root: str, n_cavs: int = 5, n_stamps: int = 4,
                         n_vehicles: int = 24, points: int = 120_000,
                         seed: int = 0,
                         ascii_cloud: Optional[Tuple[int, int]] = (1, 0)
                         ) -> Sequence[str]:
    """Write the scenario under ``root`` and return the .pcd paths.
    ``points``: about that many returns a cloud (sets the rays a beam);
    ``ascii_cloud``: the (CAV, timestamp) whose cloud is written as ASCII,
    the others binary."""
    from cobevt_tpu_torch.data.lidar_preprocess import write_pcd
    from cobevt_tpu_torch.data.objects import project_world_objects

    if n_cavs > len(CAV_POSES):
        raise ValueError(f"at most {len(CAV_POSES)} CAVs")
    rng = np.random.RandomState(seed)
    vehicles = _place_vehicles(n_vehicles, rng)
    # beams that reach the ground within MAX_RANGE
    ground_beams = int((np.tan(-BEAM_ELEVATIONS) * MAX_RANGE
                        > LIDAR_HEIGHT).sum())
    n_azimuth = -(-points // ground_beams)
    everywhere = (-1e4, -1e4, -1e4, 1e4, 1e4, 1e4)
    paths = []
    for c in range(n_cavs):
        cav_dir = os.path.join(root, "scenario_0", str(100 + c))
        os.makedirs(cav_dir, exist_ok=True)
        x0, y0, yaw = CAV_POSES[c]
        for t in range(n_stamps):
            ts = f"{t:06d}"
            pose = [x0 + t * float(np.cos(np.radians(yaw))),
                    y0 + t * float(np.sin(np.radians(yaw))), LIDAR_HEIGHT,
                    0.0, yaw, 0.0]
            near = {k: v for k, v in vehicles.items()
                    if np.hypot(v["location"][0] - pose[0],
                                v["location"][1] - pose[1]) < 70.0}
            with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                json.dump({"lidar_pose": pose, "true_ego_pos": pose,
                           "vehicles": near}, f)
            boxes = project_world_objects(near, pose, everywhere, "hwl")
            cloud = spinning_lidar_cloud(
                np.concatenate(list(boxes.values())) if boxes
                else np.zeros((0, 7)), n_azimuth, rng)
            paths.append(os.path.join(cav_dir, f"{ts}.pcd"))
            write_pcd(paths[-1], cloud, binary=(c, t) != ascii_cloud)
    return paths

"""Host input-pipeline throughput of the port's loaders.

Counterpart of ``cobevt_tpu/tools/bench_input.py``.  Builds synthetic
on-disk fixtures at the real sizes: an OPV2V scenario (5 CAVs x 4 cameras,
800 x 600 camera PNGs, per-timestamp JSON-text YAML, 256^2 BEV label PNGs)
and a generated nuScenes label directory (6 cameras at 1600 x 900,
bit-packed label PNGs, visibility PNGs, aux ``.npz``), then times the
port's loaders end to end (decode, resize, the dtype contract, collate into
tensors, ``data/loader.py``'s spawned workers) in samples/s.

Camera PNGs are written by ``data/image_io.py``'s codec, once with filter 0
on every row and once with the adaptive filters PIL and libpng choose (the
filter whose bytes have the least absolute sum, a row at a time), so the
decode cost of real files is measured, not only that of the codec's own.
A fixture draws ``CAMERA_POOL`` distinct images and its camera files
repeat them.
nuScenes cameras are JPEGs where PIL is installed, as in the dataset; where
it is not, they are PNGs and the rows say so (``camera_format``).

Pipelines a track:
  * f32      -- the dataset's float contract (OPV2V ImageNet-normalized,
               nuScenes in [0, 1]);
  * u8       -- resized uint8, the model rescales on the device;
  * u8+cache -- uint8 through ``data/cache.py``'s ``CachedDataset``
               (decoded once, then raw reads).
Each is timed over a first pass (worker start included) and a second one
(the workers kept).  A row compares the second pass with a device rate in
samples/s when one is given (``--corpbevt_device_rate``,
``--sinbevt_device_rate``: the caller's measurement of the train step's
device busy time on its card); without one it makes no comparison.

  python -m cobevt_tpu_torch.tools.bench_input [--root DIR] \\
      [--opv2v_frames 40] [--nusc_frames 48] [--num_workers 2]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

PNG_FILTERS = (0, "adaptive")
# distinct camera images a fixture draws; its camera files repeat them, each
# sample still reading and decoding files of its own
CAMERA_POOL = 12


def synth_camera(rng, h, w):
    """A road-scene-like frame: smooth gradients, noise and hard boxes, so
    that compressed sizes (and decode costs) are those of a photograph
    rather than of pure noise or flat colour.  (h, w, 3) uint8 RGB."""
    yy = np.broadcast_to(
        np.linspace(0, 1, h, dtype=np.float32)[:, None], (h, w))
    xx = np.broadcast_to(
        np.linspace(0, 1, w, dtype=np.float32)[None, :], (h, w))
    base = np.stack([120 + 80 * yy,
                     100 + 60 * (1 - yy) + 20 * xx,
                     90 + 90 * xx], -1)
    img = base + rng.normal(0, 6, (h, w, 3))
    for _ in range(12):                       # boxes: cars, buildings
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 60)
        hh, ww = rng.randint(20, 160), rng.randint(30, 240)
        img[y0:y0 + hh, x0:x0 + ww] = rng.randint(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_opv2v_fixture(root, n_cavs, n_stamps, image_hw=(600, 800),
                        bev=256, seed=0, row_filter=0,
                        camera_pool: Optional[int] = None):
    """One scenario of ``n_cavs`` CAVs x ``n_stamps`` timestamps in the
    OPV2V on-disk layout: per timestamp a JSON-text YAML file (poses within
    the communication range, 4 cameras), four camera PNGs at ``image_hw``
    and the five label PNGs at ``bev``^2, written by the codec with
    ``row_filter``.  ``camera_pool``: draw only that many distinct camera
    images and let the files repeat them."""
    from cobevt_tpu_torch.data.image_io import encode_png, write_png

    rng = np.random.RandomState(seed)
    H, W = image_hw
    pool = []
    for c in range(n_cavs):
        cav_dir = os.path.join(root, "scenario_0", str(100 + c))
        os.makedirs(cav_dir, exist_ok=True)
        for t in range(n_stamps):
            ts = f"{t:06d}"
            pose = [8.0 * c + t, 3.0 * c, 0.0, 0.0, 15.0 * c, 0.0]
            params = {"lidar_pose": pose, "true_ego_pos": pose}
            for m in range(4):
                params[f"camera{m}"] = {
                    "cords": [pose[0], pose[1] + 0.5 * m, 1.8, 0.0,
                              pose[4] + 90.0 * m, 0.0],
                    "intrinsic": [[0.9 * W, 0.0, W / 2],
                                  [0.0, 0.9 * W, H / 2], [0.0, 0.0, 1.0]],
                    "extrinsic": np.eye(4).tolist()}
            with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as f:
                json.dump(params, f)
            for m in range(4):
                k = (c * n_stamps + t) * 4 + m
                if camera_pool is None or k < camera_pool:
                    data = encode_png(synth_camera(rng, H, W)[..., ::-1],
                                      row_filter)
                    if camera_pool is not None:
                        pool.append(data)
                else:
                    data = pool[k % camera_pool]
                with open(os.path.join(cav_dir, f"{ts}_camera{m}.png"),
                          "wb") as f:
                    f.write(data)
            for ext in ("bev_dynamic.png", "bev_static.png", "bev_lane.png",
                        "bev_visibility.png", "bev_visibility_corp.png"):
                write_png(os.path.join(cav_dir, f"{ts}_{ext}"),
                          (rng.rand(bev, bev) > 0.9).astype(np.uint8) * 255,
                          row_filter)


# nuScenes-like camera rig: CAM_FRONT's intrinsics at 1600 x 900 and six
# cameras around the ego, yaw in degrees
NUSC_INTRINSIC = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5],
                  [0.0, 0.0, 1.0]]
NUSC_YAWS = (0.0, -55.0, 55.0, 180.0, -110.0, 110.0)
# the 200 x 200 BEV over 100 m around the ego (get_view_matrix)
NUSC_VIEW = [[0.0, -2.0, 100.0], [-2.0, 0.0, 100.0], [0.0, 0.0, 1.0]]


def nusc_extrinsic(yaw_deg: float) -> list:
    """Ego -> camera for a camera 1.5 m up at the ego's centre, looking
    along ``yaw_deg`` (camera z forward, x right, y down)."""
    yaw = np.deg2rad(yaw_deg)
    fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    R = np.stack([right, down, fwd])           # rows: camera axes in ego
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ np.array([0.0, 0.0, 1.5])
    return E.tolist()


def write_nuscenes_fixture(root, n_scenes, n_samples, n_cam=6,
                           cam_hw=(900, 1600), bev=200, seed=0, row_filter=0,
                           camera_format="png",
                           camera_pool: Optional[int] = None):
    """``n_scenes`` scenes of ``n_samples`` samples in the generated-label
    layout, written by the port's ``save_scene_labels``: ``n_cam`` cameras
    at ``cam_hw`` (PNGs by the codec with ``row_filter``, or JPEGs by PIL
    at quality 90), 12-class bit-packed BEV labels, visibility levels 0-4
    and aux maps at ``bev``^2.  ``camera_pool``: write only that many
    distinct camera files and let the samples share them.  Returns
    (dataset_dir, labels_dir)."""
    from cobevt_tpu_torch.data.image_io import write_png
    from cobevt_tpu_torch.data.nuscenes_labelgen import save_scene_labels

    rng = np.random.RandomState(seed)
    data_dir = os.path.join(root, "data")
    labels_dir = os.path.join(root, "labels")
    os.makedirs(data_dir, exist_ok=True)
    total = n_scenes * n_samples * n_cam
    pool = min(camera_pool or total, total)
    names = []
    for i in range(pool):
        name = f"cam_{i:05d}.{camera_format}"
        img = synth_camera(rng, *cam_hw)
        if camera_format == "png":
            write_png(os.path.join(data_dir, name), img[..., ::-1],
                      row_filter)
        else:
            from PIL import Image
            Image.fromarray(img).save(os.path.join(data_dir, name),
                                      quality=90)
        names.append(name)
    extrinsics = [nusc_extrinsic(NUSC_YAWS[c % len(NUSC_YAWS)])
                  for c in range(n_cam)]
    k = 0
    for s in range(n_scenes):
        samples = []
        for i in range(n_samples):
            images = []
            for _ in range(n_cam):
                images.append(names[k % pool])
                k += 1
            samples.append({
                "token": f"{s:03d}{i:04d}", "images": images,
                "intrinsics": [NUSC_INTRINSIC] * n_cam,
                "extrinsics": extrinsics, "view": NUSC_VIEW,
                "pose": np.eye(4).tolist(),
                "bev": (rng.rand(bev, bev, 12) > 0.9).astype(np.uint8) * 255,
                "visibility": rng.randint(0, 5, (bev, bev)).astype(np.uint8),
                "aux": rng.rand(bev, bev, 2).astype(np.float32)})
        save_scene_labels(f"scene-{s:04d}", samples, labels_dir)
    return data_dir, labels_dir


def time_loader(loader, max_seconds=60.0, min_batches=4):
    """(samples/s, samples) over one pass, cut after ``max_seconds`` once
    ``min_batches`` came: decode, transform and collate in the loader's
    workers, overlapped as in training."""
    n_samples = n_batches = 0
    t0 = time.perf_counter()
    for batch in loader:
        n_samples += len(next(iter(batch.values())))
        n_batches += 1
        if (time.perf_counter() - t0 > max_seconds
                and n_batches >= min_batches):
            break
    return n_samples / (time.perf_counter() - t0), n_samples


def bench_track(name, make_dataset, batch_size, device_rate, cache_dir,
                num_workers, results, **fields):
    """Rows of the f32, u8 and u8+cache pipelines of one fixture."""
    from cobevt_tpu_torch.data.cache import CachedDataset
    from cobevt_tpu_torch.data.loader import DataLoader

    def run(pipeline, dataset, collate=None):
        loader = DataLoader(dataset, batch_size, shuffle=False,
                            drop_last=False, num_workers=num_workers,
                            collate=collate)
        first, _ = time_loader(loader)
        sps, n = time_loader(loader)
        loader.close()
        row = {"track": name, "pipeline": pipeline, **fields,
               "samples_per_sec": sps, "first_pass_samples_per_sec": first,
               "samples_timed": n, "batch": batch_size,
               "num_workers": num_workers, "device_rate": device_rate,
               "feeds_chip": (None if device_rate is None
                              else bool(sps >= device_rate)),
               "host_over_device": (None if device_rate is None
                                    else sps / device_rate)}
        results.append(row)
        print(json.dumps(row))

    run("f32", make_dataset(normalize=True))
    run("u8", make_dataset(normalize=False))
    cached = CachedDataset(make_dataset(normalize=False), cache_dir)
    cached.warm()
    run("u8+cache", cached, cached.collate)


def parse_args(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch input-pipeline benchmark")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "cobevt_input_fixture"))
    p.add_argument("--opv2v_frames", type=int, default=40)
    p.add_argument("--nusc_frames", type=int, default=48)
    p.add_argument("--num_workers", type=int, default=2,
                   help="loader worker processes")
    p.add_argument("--corpbevt_device_rate", type=float, default=None,
                   help="samples/s of the CorpBEVT train step at batch 1 on "
                        "the card (its device busy time), to compare with")
    p.add_argument("--sinbevt_device_rate", type=float, default=None,
                   help="samples/s of the SinBEVT nuScenes train step at "
                        "batch 8 on the card (its device busy time), to "
                        "compare with")
    p.add_argument("--filters", default=",".join(map(str, PNG_FILTERS)),
                   help="the camera PNGs' row filters, one fixture each "
                        "(0-4 or adaptive)")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    from cobevt_tpu_torch.data import nuscenes_gen
    from cobevt_tpu_torch.data.nuscenes_gen import (
        ImageConfig,
        NuScenesGeneratedDataset,
    )
    from cobevt_tpu_torch.data.opv2v import (
        OPV2VCameraDataset,
        OPV2VScenarioDatabase,
    )

    filters: Sequence = [f if f == "adaptive" else int(f)
                         for f in opt.filters.split(",")]
    nusc_format = "png" if nuscenes_gen.Image is None else "jpg"
    results = []
    t0 = time.perf_counter()
    fixtures = []
    for f in filters:
        base = os.path.join(opt.root, f"filter_{f}")
        opv2v = os.path.join(base, "opv2v")
        if not os.path.isdir(opv2v):
            write_opv2v_fixture(opv2v, 5, opt.opv2v_frames, row_filter=f,
                                camera_pool=CAMERA_POOL)
        fixtures.append(("opv2v", f, opv2v))
    for f in (filters if nusc_format == "png" else [None]):
        base = os.path.join(opt.root, f"nuscenes_{nusc_format}_{f}")
        if not os.path.isdir(base):
            write_nuscenes_fixture(base, 1, opt.nusc_frames, row_filter=f or 0,
                                   camera_format=nusc_format,
                                   camera_pool=CAMERA_POOL)
        fixtures.append(("nuscenes", f, base))
    print(json.dumps({"fixture": opt.root, "opv2v_frames": opt.opv2v_frames,
                      "nusc_frames": opt.nusc_frames,
                      "camera_pool": CAMERA_POOL,
                      "build_s": time.perf_counter() - t0,
                      "host_cores": os.cpu_count()}))

    for track, f, path in fixtures:
        cache_dir = os.path.join(opt.root, "cache", f"{track}_{f}")
        if track == "opv2v":
            db = OPV2VScenarioDatabase(path, max_cav=5)

            def make(normalize=True, db=db):
                return OPV2VCameraDataset(db, image_hw=(512, 512),
                                          normalize=normalize)
            bench_track("corpbevt_opv2v", make, 1, opt.corpbevt_device_rate,
                        cache_dir, opt.num_workers, results,
                        camera_format="png", png_filter=f)
        else:
            def make(normalize=True, path=path):
                return NuScenesGeneratedDataset(
                    "scene-0000", os.path.join(path, "data"),
                    os.path.join(path, "labels"), ImageConfig(),
                    raw_uint8=not normalize)
            bench_track("sinbevt_nuscenes", make, 8, opt.sinbevt_device_rate,
                        cache_dir, opt.num_workers, results,
                        camera_format=nusc_format, png_filter=f)
    return results


if __name__ == "__main__":
    main()

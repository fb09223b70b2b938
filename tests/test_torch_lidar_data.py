"""The LiDAR host data path, port vs JAX: .pcd reading, point masks and
augmentations, voxelization, object ground truth, the cooperative LiDAR
dataset and its loader.

The same numpy draws from a seed go through ``cobevt_tpu/data/`` and
``cobevt_tpu_torch/data/``.  Tolerance: none.  Every array is equal
(``assert_array_equal``): both sides run the same numpy arithmetic, and the
port's vectorised voxelizer copies the points the JAX loop copies.  The
dataset runs on the fixture tree of ``tests/test_lidar_dataset_e2e.py``.
"""

import dataclasses
import multiprocessing
import time

import numpy as np
import pytest

from cobevt_tpu.data import lidar_preprocess as jlp
from cobevt_tpu.data import objects as jobj
from cobevt_tpu.data import voxelize as jvox
from cobevt_tpu.data.loader import DataLoader as JaxDataLoader
from cobevt_tpu.data.opv2v import OPV2VScenarioDatabase as JaxDatabase
from cobevt_tpu.data.opv2v_lidar import OPV2VLidarDataset as JaxLidarDataset
from cobevt_tpu_torch.data import lidar_preprocess as plp
from cobevt_tpu_torch.data import objects as pobj
from cobevt_tpu_torch.data import voxelize as pvox
from cobevt_tpu_torch.data.loader import DataLoader
from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase
from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset
from cobevt_tpu_torch.postprocess import voxel_postprocessor as ppost
from tests.test_lidar_dataset_e2e import (
    PC_RANGE,
    VOXEL,
    make_post,
    write_lidar_fixture,
)
from tests.test_torch_loader_samples import (
    FailingSamples,
    SlowFullWidthVoxels,
)

DATASET_KW = dict(voxel_size=VOXEL, lidar_range=PC_RANGE, max_voxels=256,
                  max_points_per_voxel=8, max_objects=10)


def _cloud(seed, n=3000, lo=-18.0, hi=18.0):
    rng = np.random.RandomState(seed)
    return np.column_stack([rng.uniform(lo, hi, (n, 2)),
                            rng.uniform(-3.5, 1.5, n),
                            rng.rand(n)]).astype(np.float32)


def _header(fields, sizes, types, n, data):
    return (f"# .PCD v0.7\nVERSION .7\nFIELDS {fields}\nSIZE {sizes}\n"
            f"TYPE {types}\nCOUNT 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
            f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {data}\n").encode()


def test_load_pcd_binary_and_ascii_equal_the_jax_packages(tmp_path):
    """A binary file with a 16-bit ring field after the four the reader
    keeps, an ASCII file, and the port's writer read by both readers."""
    pts = _cloud(0, 500)
    rec = np.zeros(500, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                         ("intensity", "<f4"), ("ring", "<u2")])
    for i, k in enumerate(("x", "y", "z", "intensity")):
        rec[k] = pts[:, i]
    rec["ring"] = np.arange(500) % 64
    binary = tmp_path / "binary.pcd"
    binary.write_bytes(_header("x y z intensity ring", "4 4 4 4 2",
                               "F F F F U", 500, "binary") + rec.tobytes())
    ascii_ = tmp_path / "ascii.pcd"
    with open(ascii_, "wb") as f:
        f.write(_header("x y z intensity", "4 4 4 4", "F F F F", 500,
                        "ascii"))
        np.savetxt(f, pts, fmt="%.6f")
    for path in (binary, ascii_):
        got = plp.load_pcd(str(path))
        assert got.dtype == np.float32 and got.shape == (500, 4)
        np.testing.assert_array_equal(got, jlp.load_pcd(str(path)))
    np.testing.assert_array_equal(plp.load_pcd(str(binary)), pts)
    for binary_ in (True, False):
        path = str(tmp_path / f"written_{binary_}.pcd")
        plp.write_pcd(path, pts, binary=binary_)
        np.testing.assert_array_equal(jlp.load_pcd(path), pts)


def test_point_masks_and_samplers_equal_the_jax_packages():
    pts = _cloud(1)
    lr = (-10, -8, -3, 10, 8, 1)
    np.testing.assert_array_equal(plp.mask_points_by_range(pts, lr),
                                  jlp.mask_points_by_range(pts, lr))
    np.testing.assert_array_equal(plp.mask_ego_points(pts),
                                  jlp.mask_ego_points(pts))
    np.testing.assert_array_equal(
        plp.shuffle_points(pts, np.random.RandomState(2)),
        jlp.shuffle_points(pts, np.random.RandomState(2)))
    for num in (1000, 5000):
        np.testing.assert_array_equal(
            plp.downsample_points(pts, num, np.random.RandomState(3)),
            jlp.downsample_points(pts, num, np.random.RandomState(3)))
    geometry = {"L1": -16.0, "W1": -16.0, "H1": -3.0, "res": 0.5,
                "input_shape": (64, 64, 9)}
    np.testing.assert_array_equal(plp.points_to_bev(pts, geometry),
                                  jlp.points_to_bev(pts, geometry))


@pytest.mark.parametrize("axes", [["x"], ["x", "y"]])
def test_augmentor_draws_equal_the_jax_packages(axes):
    """Three calls of a seeded augmentor: the same draws, the same boxes and
    points; drawing ahead (``draw``) and applying later gives them too."""
    config = [{"name": "random_world_flip", "along_axis_list": axes},
              {"name": "random_world_rotation",
               "world_rot_angle": [-0.78539816, 0.78539816]},
              {"name": "random_world_scaling",
               "world_scale_range": [0.95, 1.05]}]
    boxes = np.random.RandomState(4).uniform(-10, 10, (6, 7))
    pts = _cloud(5, 200)
    want = jlp.DataAugmentor(config, seed=11)
    got = plp.DataAugmentor(config, seed=11)
    ahead = plp.DataAugmentor(config, seed=11)
    for _ in range(3):
        wb, wp = want(boxes, pts)
        gb, gp = got(boxes, pts)
        draws = ahead.draw()
        assert len(draws) == len(axes) + 2
        ab, ap = ahead(boxes, pts, draws)
        for g in ((gb, gp), (ab, ap)):
            np.testing.assert_array_equal(g[0], wb)
            np.testing.assert_array_equal(g[1], wp)


@pytest.mark.parametrize("max_voxels,max_points", [(4000, 32), (256, 8),
                                                   (100, 3)])
def test_voxelize_is_bit_equal_to_the_jax_loop(max_voxels, max_points):
    """A 40 x 40 pillar grid (its fullest pillar holds 9 points): with the
    caps above what the cloud occupies, and with the cloud overflowing
    ``max_voxels`` (the first voxels in flat-cell order kept) and the points
    a voxel holds."""
    pts = _cloud(6, 6000)
    occupied = pvox.occupied_voxels(pts, VOXEL, PC_RANGE)
    assert (occupied > max_voxels) == (max_voxels < 4000)
    got = pvox.voxelize_points(pts, VOXEL, PC_RANGE, max_voxels, max_points)
    want = jvox.voxelize_points(pts, VOXEL, PC_RANGE, max_voxels, max_points)
    assert got.keys() == want.keys()
    for k in want:
        if k == "grid_size":
            assert got[k] == want[k] == (40, 40, 1)
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["voxel_mask"].sum()) == min(occupied, max_voxels)
    assert got["voxel_num_points"].max() == min(max_points, 9)
    empty = pvox.voxelize_points(pts[:0], VOXEL, PC_RANGE, 16, 4)
    assert not empty["voxel_mask"].any()


def _cav_params(rng, n_cavs=3, n_vehicles=6):
    out = []
    for c in range(n_cavs):
        vehicles = {}
        for v in range(n_vehicles):
            vehicles[100 * c + v] = {
                "location": rng.uniform(-30, 30, 3).tolist(),
                "center": rng.uniform(-0.3, 0.3, 3).tolist(),
                "angle": rng.uniform(-20, 20, 3).tolist(),
                "extent": rng.uniform(0.6, 2.4, 3).tolist()}
        out.append({"lidar_pose": rng.uniform(-5, 5, 6).tolist(),
                    "vehicles": vehicles})
    return out


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_object_centers_equal_the_jax_packages(order):
    rng = np.random.RandomState(7)
    params = _cav_params(rng)
    for lr in (jobj.GT_RANGE, (-20, -20, -40, 20, 20, 40)):
        want = jobj.generate_object_center(params, params[0]["lidar_pose"],
                                           12, order, lidar_range=lr)
        got = pobj.generate_object_center(params, params[0]["lidar_pose"],
                                          12, order, lidar_range=lr)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert pobj.GT_RANGE == jobj.GT_RANGE
    np.testing.assert_array_equal(pobj.create_bbx([1.0, 0.5, 0.7]),
                                  jobj.create_bbx([1.0, 0.5, 0.7]))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lidar") / "train")
    write_lidar_fixture(path)
    return path


def _post(args):
    return ppost.VoxelPostprocessor(
        ppost.AnchorArgs(**dataclasses.asdict(args)), "hwl", 0.3, 0.2, 0.2,
        0.15, 50)


def _pair(root, train, augment, seed=0):
    jpost = make_post()
    ref = JaxLidarDataset(JaxDatabase(root, max_cav=2), jpost,
                          augment=augment, train=train, seed=seed,
                          **DATASET_KW)
    port = OPV2VLidarDataset(OPV2VScenarioDatabase(root, max_cav=2),
                             _post(jpost.args), augment=augment, train=train,
                             seed=seed, **DATASET_KW)
    return ref, port


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if hasattr(got[k], "numpy") else got[k]
        assert g.dtype == want[k].dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


@pytest.mark.parametrize("train,augment", [(True, False), (True, True),
                                           (False, False)])
def test_dataset_samples_equal_the_jax_packages(root, train, augment):
    """Train (lidar-range ground truth, with and without the augmentor's
    draws) and eval (GT_RANGE): each sample key by key, twice over so the
    draws go on."""
    ref, port = _pair(root, train, augment, seed=5)
    assert len(port) == len(ref) == 2
    assert port.draws_random == (train and augment)
    for _ in range(2):
        for i in range(len(ref)):
            _assert_samples_equal(port[i], ref[i])
    s = port[0]
    assert s["voxel_features"].shape == (2, 256, 8, 4)
    assert s["agent_mask"].sum() == 2 and s["object_bbx_mask"].sum() >= 1
    batch = port.collate([port[0], port[1]])
    assert {k: v.shape[0] for k, v in batch.items()} == dict.fromkeys(s, 2)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_order_and_draws_equal_the_jax_loaders(root, workers):
    """augment=True: over two epochs the port's loader (its draws planned in
    the loading process, in batch order) gives the JAX loader's batches,
    with no worker and with two spawned ones."""
    ref, port = _pair(root, train=True, augment=True, seed=9)
    kw = dict(batch_size=1, shuffle=True, seed=3)
    jl = JaxDataLoader(ref, **kw)
    pl = DataLoader(port, num_workers=workers, **kw)
    try:
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want, got = list(jl), list(pl)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                _assert_samples_equal(g, w)
    finally:
        pl.close()


def test_loader_early_break_with_large_batches_in_flight():
    """An iteration abandoned while both workers are still making 20 MB
    batches: the loader reads them, then stops its workers, and none aborts
    (before, a worker stopped mid-batch aborted as it exited, and the
    loader raised)."""
    loader = DataLoader(SlowFullWidthVoxels(), batch_size=1, shuffle=False,
                        drop_last=False, num_workers=2, prefetch=2)
    it = iter(loader)
    assert next(it)["voxel_features"].shape == (1, 5, 8000, 32, 4)
    workers = list(loader._torch_loader._iterator._workers)
    it.close()
    deadline = time.time() + 10
    while multiprocessing.active_children() and time.time() < deadline:
        time.sleep(0.1)
    assert multiprocessing.active_children() == []
    assert [w.exitcode for w in workers] == [0, 0]


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_loader_early_break_with_a_failed_worker_stops_the_workers(
        tmp_path, how):
    """An iteration abandoned while a worker fails on a batch not read yet.
    A sample that raises is read and dropped with its batch; a worker that
    exits makes close() raise torch's error.  Either way every worker is
    stopped, and the next iteration spawns new ones that give every batch."""
    release = tmp_path / "release"
    dataset = FailingSamples(fail_at=1, how=how, release=str(release))
    loader = DataLoader(dataset, batch_size=1, shuffle=False,
                        drop_last=False, num_workers=2, prefetch=2)
    it = iter(loader)
    assert next(it)["x"][0, 0].item() == 0
    workers = list(loader._torch_loader._iterator._workers)
    release.touch()
    err = None
    if how == "raise":
        it.close()
    else:
        # the error is held (its traceback holds the torch iterator), so
        # only close() itself can have stopped the workers
        with pytest.raises(RuntimeError, match="exited unexpectedly") as err:
            it.close()
    assert loader._torch_loader is None
    for w in workers:
        w.join(timeout=10)
    assert not any(w.is_alive() for w in workers)
    del err
    dataset.fail_at = None
    try:
        assert [b["x"][0, 0].item() for b in loader] == list(range(6))
    finally:
        loader.close()


def test_spinning_sensor_scenario_reads_back(tmp_path):
    """tools/lidar_fixture.py at a small point count: the clouds (one ASCII)
    read back at about the count asked for, denser near the sensor, and the
    dataset finds all 24 vehicles in range with targets that decode back."""
    from cobevt_tpu_torch.tools.debug_utils import check_anchor_roundtrip
    from cobevt_tpu_torch.tools.lidar_fixture import write_lidar_scenario

    root = str(tmp_path / "scenario")
    paths = write_lidar_scenario(root, n_cavs=2, n_stamps=1, points=6000)
    assert len(paths) == 2
    heads = [open(p, "rb").read(200) for p in paths]
    assert [b"DATA ascii" in h for h in heads] == [False, True]
    for path in paths:
        pts = plp.load_pcd(path)
        assert 5900 <= len(pts) <= 6400
        r = np.hypot(pts[:, 0], pts[:, 1])
        assert (r < 20).sum() > (r > 40).sum()
    rng = (-70.4, -38.4, -3, 70.4, 38.4, 1)
    post = ppost.VoxelPostprocessor(ppost.AnchorArgs(
        cav_lidar_range=rng, W=352, H=192, feature_stride=2))
    ds = OPV2VLidarDataset(OPV2VScenarioDatabase(root, max_cav=5), post,
                           voxel_size=(0.4, 0.4, 4.0), lidar_range=rng,
                           max_voxels=4000, max_points_per_voxel=8)
    s = ds[0]
    assert s["agent_mask"].tolist() == [1, 1, 0, 0, 0]
    assert s["object_bbx_mask"].sum() == 24
    assert check_anchor_roundtrip(post, s["object_bbx_center"],
                                  s["object_bbx_mask"])

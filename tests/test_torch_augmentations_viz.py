"""The numpy modules of the port against the JAX package's: the image
augmentations (``StrongAug``, ``GeometricAug``), ``camera_viz``'s
projection and drawing, and ``merge_dynamic_static`` (``merge_maps`` and
its ``main`` on a temporary directory).

Tolerances: the augmentations and the drawings are bit-equal (the same
draws from the same ``RandomState`` seed, the same arithmetic); the
projection 1e-5 abs/rel.
"""

import os

import numpy as np
import pytest

from cobevt_tpu.data import augmentations as jaug
from cobevt_tpu.geometry import boxes as jboxes
from cobevt_tpu.tools import merge_dynamic_static as jmerge
from cobevt_tpu.utils import camera_viz as jviz
from cobevt_tpu_torch.data import augmentations as paug
from cobevt_tpu_torch.data.image_io import imread
from cobevt_tpu_torch.geometry import boxes as pboxes
from cobevt_tpu_torch.tools import merge_dynamic_static as pmerge
from cobevt_tpu_torch.utils import camera_viz as pviz

DRAWS = 20


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_strong_aug_bit_equal(p):
    rng = np.random.RandomState(0)
    port, ref = paug.StrongAug(p=p, seed=3), jaug.StrongAug(p=p, seed=3)
    for _ in range(DRAWS):
        img = rng.rand(12, 16, 3).astype(np.float32)
        np.testing.assert_array_equal(port(img), ref(img))


def test_geometric_aug_bit_equal():
    rng = np.random.RandomState(1)
    port = paug.GeometricAug(max_scale=0.2, max_shift=0.1, seed=4)
    ref = jaug.GeometricAug(max_scale=0.2, max_shift=0.1, seed=4)
    K = np.array([[100.0, 0, 8], [0, 100.0, 6], [0, 0, 1]], np.float32)
    moved = 0
    for _ in range(DRAWS):
        img = rng.rand(12, 16, 3).astype(np.float32)
        got, got_k = port(img, K)
        want, want_k = ref(img, K)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_k, want_k)
        moved += not np.array_equal(got_k, K)
    assert 0 < moved < DRAWS
    assert set(paug.AUGMENTATIONS) == set(jaug.AUGMENTATIONS)


def _boxes_and_camera():
    boxes = np.array([[12.0, 1.0, 0.5, 1.6, 1.8, 4.2, 0.3],
                      [20.0, -3.0, 0.8, 1.5, 1.9, 4.5, -0.7],
                      [-8.0, 0.0, 0.5, 1.5, 1.9, 4.5, 0.0]], np.float32)
    pose = np.eye(4)
    pose[:3, 3] = [0.0, 0.0, 1.6]
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]])
    return boxes, pose, K


def test_camera_projection_matches():
    boxes, pose, K = _boxes_and_camera()
    corners = pboxes.boxes_to_corners_3d(boxes, "hwl")
    np.testing.assert_array_equal(corners,
                                  jboxes.boxes_to_corners_3d(boxes, "hwl"))
    pix, front = pviz.project_to_camera(corners, pose, K)
    want_pix, want_front = jviz.project_to_camera(corners, pose, K)
    np.testing.assert_allclose(pix, want_pix, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(front, want_front)
    # the two boxes ahead are in front, the one behind is not
    assert front[:2].all() and not front[2].any()
    assert pviz.BOX_EDGES == jviz.BOX_EDGES


def test_camera_drawing_bit_equal():
    pytest.importorskip("cv2")
    boxes, pose, K = _boxes_and_camera()
    corners = pboxes.boxes_to_corners_3d(boxes, "hwl")
    pix, front = pviz.project_to_camera(corners, pose, K)
    image = np.zeros((240, 320, 3), np.uint8)
    got3 = pviz.draw_3d_boxes(image, pix, front)
    np.testing.assert_array_equal(got3, jviz.draw_3d_boxes(image, pix, front))
    got2 = pviz.draw_2d_boxes(image, pix, front)
    np.testing.assert_array_equal(got2, jviz.draw_2d_boxes(image, pix, front))
    assert got3.any() and got2.any() and not image.any()


def _class_maps(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2, (16, 20)).astype(np.int64),
            rng.randint(0, 3, (16, 20)).astype(np.int64))


def test_merge_maps_equal():
    dyn, sta = _class_maps()
    got = pmerge.merge_maps(dyn, sta)
    np.testing.assert_array_equal(got, jmerge.merge_maps(dyn, sta))
    assert (got[dyn > 0] == pmerge.DYNAMIC_COLORS[1]).all()


def test_merge_dynamic_static_main(tmp_path):
    dyn_dir, sta_dir, out = (os.path.join(tmp_path, d)
                             for d in ("dyn", "sta", "out"))
    os.makedirs(dyn_dir)
    os.makedirs(sta_dir)
    maps = {}
    for i in range(3):
        maps[f"{i:06d}.npy"] = _class_maps(i)
        np.save(os.path.join(dyn_dir, f"{i:06d}.npy"), maps[f"{i:06d}.npy"][0])
        np.save(os.path.join(sta_dir, f"{i:06d}.npy"), maps[f"{i:06d}.npy"][1])
    # a frame only the dynamic run has is skipped
    np.save(os.path.join(dyn_dir, "000009.npy"), _class_maps(9)[0])
    n = pmerge.main(["--dynamic_dir", dyn_dir, "--static_dir", sta_dir,
                     "--out", out])
    assert n == 3
    assert sorted(os.listdir(out)) == [f"{i:06d}.png" for i in range(3)]
    for name, (dyn, sta) in maps.items():
        img = imread(os.path.join(out, name.replace(".npy", ".png")))
        np.testing.assert_array_equal(img, jmerge.merge_maps(dyn, sta))

"""Box geometry and the box kernels' routes, port vs JAX.

Every function of ``cobevt_tpu_torch/geometry/boxes.py`` against
``cobevt_tpu/geometry/boxes.py`` on the same numpy draws from a seed, and
``cobevt_tpu_torch/utils/native_ops.py`` (its own g++ build of
``csrc/box_ops.cpp``) route by route against the JAX package's native
route.  Tolerance: 1e-6 absolute on float outputs (the clipped areas are
f64, the axis-aligned IoUs f32 in the same order of operations); kept
indices exact.  The two NMS routes part past 1000 candidates in both
packages alike: the numpy route keeps only the 1000 best-scored.
"""

import numpy as np
import pytest

from cobevt_tpu.geometry import boxes as jb
from cobevt_tpu.utils import native_ops as jn
from cobevt_tpu_torch.geometry import boxes as pb
from cobevt_tpu_torch.utils import native_ops as pn

ATOL = 1e-6


def _boxes3d(seed, n=40):
    rng = np.random.RandomState(seed)
    return np.column_stack([
        rng.uniform(-30, 30, (n, 2)), rng.uniform(-2, 0, n),
        rng.uniform(1.4, 1.8, n), rng.uniform(1.5, 2.0, n),
        rng.uniform(3.5, 4.8, n), rng.uniform(-np.pi, np.pi, n)])


def _boxes2d(seed, n, spread=10.0):
    rng = np.random.RandomState(seed)
    return np.column_stack([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(1, 4, (n, 2)),
        rng.uniform(-3, 3, n)])


def _standup(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 20, (n, 2))
    return np.column_stack([xy, xy + rng.uniform(0.5, 6, (n, 2))])


def _pose(rng):
    a = rng.uniform(-np.pi, np.pi)
    T = np.eye(4)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.uniform(-5, 5, 3)
    return T


@pytest.mark.parametrize("order", ["lwh", "hwl"])
def test_corner_functions_equal_the_jax_packages(order):
    boxes = _boxes3d(0)
    corners = pb.boxes_to_corners_3d(boxes, order)
    np.testing.assert_allclose(
        corners, jb.boxes_to_corners_3d(boxes, order), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        pb.boxes_to_corners2d(boxes, order),
        jb.boxes_to_corners2d(boxes, order), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        pb.corner_to_center(corners, order),
        jb.corner_to_center(corners, order), rtol=0, atol=ATOL)
    b2 = _boxes2d(1, 30).reshape(5, 6, 5)
    np.testing.assert_allclose(pb.boxes2d_to_corners2d(b2),
                               jb.boxes2d_to_corners2d(b2), rtol=0,
                               atol=ATOL)


def test_projection_and_range_mask_equal_the_jax_packages():
    rng = np.random.RandomState(2)
    T = _pose(rng)
    pts = rng.uniform(-40, 40, (100, 3))
    np.testing.assert_allclose(pb.project_points(pts, T),
                               jb.project_points(pts, T), rtol=0, atol=ATOL)
    corners = pb.boxes_to_corners_3d(_boxes3d(3), "hwl")
    np.testing.assert_allclose(pb.project_box3d(corners, T),
                               jb.project_box3d(corners, T), rtol=0,
                               atol=ATOL)
    lr = (-25, -20, -3, 25, 20, 1)
    for k in (1, 4, 8):
        want = jb.mask_boxes_outside_range(_boxes3d(3), lr, "hwl", k)
        np.testing.assert_array_equal(
            pb.mask_boxes_outside_range(_boxes3d(3), lr, "hwl", k), want)
        assert 0 < want.sum() < len(want)


def test_axis_aligned_overlaps_equal_the_jax_packages():
    a, q = _standup(4, 50), _standup(5, 20)
    np.testing.assert_array_equal(pb.bbox_overlaps(a, q),
                                  jb.bbox_overlaps(a, q))
    np.testing.assert_array_equal(pb.bbox_intersections(a, q),
                                  jb.bbox_intersections(a, q))


@pytest.mark.parametrize("seed", [6, 7])
def test_rotated_iou_and_clip_area_equal_the_jax_packages(seed):
    """The port clips every pair at once, the JAX package one pair at a
    time in a Python loop: the same vertices, the same areas."""
    ca = jb.boxes2d_to_corners2d(_boxes2d(seed, 30, spread=4.0))
    cb = jb.boxes2d_to_corners2d(_boxes2d(seed + 10, 25, spread=4.0))
    want = jb.rotated_iou(ca, cb)
    got = pb.rotated_iou(ca, cb)
    assert 0.3 < (want > 0).mean() < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pb.convex_clip_area(ca[:25], cb),
                               jb.convex_clip_area(ca[:25], cb), rtol=0,
                               atol=ATOL)
    assert pb.rotated_iou(ca[:0], cb).shape == (0, 25)


def test_nms_equals_the_jax_packages():
    corners = jb.boxes2d_to_corners2d(_boxes2d(8, 80))
    scores = np.random.RandomState(9).rand(80)
    for thr in (0.05, 0.15, 0.5):
        want = jb.nms_rotated(corners, scores, thr)
        got = pb.nms_rotated(corners, scores, thr)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert len(pb.nms_rotated(corners[:0], scores[:0], 0.1)) == 0


def test_native_and_numpy_routes_equal_each_other_and_the_jax_native():
    """bbox_overlaps, bbox_intersections, rotated_iou and nms_rotated at 300
    candidates (under the numpy route's 1000): the port's native route
    (its own build), its numpy route and the JAX package's native route
    agree, and each call counts on the route that ran."""
    if jn.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    assert pn.get_lib() is not None, pn.build_error()
    assert pn.library_path().startswith(pn.BUILD_DIR)
    before = {k: dict(v) for k, v in pn.route_calls.items()}

    a, q = _standup(10, 200), _standup(11, 30)
    want = jn.bbox_overlaps(a, q)
    for route in ("native", "numpy"):
        np.testing.assert_allclose(pn.bbox_overlaps(a, q, route=route),
                                   want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            pn.bbox_intersections(a, q, route=route),
            jn.bbox_intersections(a, q), rtol=0, atol=ATOL)

    corners = jb.boxes2d_to_corners2d(_boxes2d(12, 300, spread=25.0))
    scores = np.random.RandomState(13).rand(300)
    want = jn.rotated_iou(corners[:60], corners)
    for route in ("native", "numpy"):
        np.testing.assert_allclose(
            pn.rotated_iou(corners[:60], corners, route=route), want,
            rtol=0, atol=ATOL)
    for thr in (0.1, 0.3):
        want = jn.nms_rotated(corners, scores, thr)
        assert len(want) < 300
        for route in ("native", "numpy"):
            np.testing.assert_array_equal(
                pn.nms_rotated(corners, scores, thr, route=route), want)

    calls = {k: {r: pn.route_calls[k][r] - before[k][r] for r in pn.ROUTES}
             for k in pn.route_calls}
    assert calls == {"bbox_overlaps": {"native": 1, "numpy": 1},
                     "bbox_intersections": {"native": 1, "numpy": 1},
                     "rotated_iou": {"native": 1, "numpy": 1},
                     "nms_rotated": {"native": 2, "numpy": 2}}
    # the default takes the native route where the library builds
    pn.nms_rotated(corners, scores, 0.1)
    assert pn.route_calls["nms_rotated"]["native"] == \
        before["nms_rotated"]["native"] + 3
    with pytest.raises(ValueError):
        pn.rotated_iou(corners, corners, route="cuda")


def test_nms_routes_part_past_1000_candidates_in_both_packages(monkeypatch):
    """1100 disjoint boxes: the native route keeps all of them, the numpy
    route the 1000 best-scored, in the port as in the JAX package.  (The
    JAX numpy route's IoU, one Python iteration a pair, is swapped for the
    JAX native IoU here: the test is about the cut, and the boxes are
    disjoint, so every IoU is 0 either way.)"""
    n = 1100
    g = np.arange(n)
    boxes = np.column_stack([(g % 40) * 10.0, (g // 40) * 10.0,
                             np.full(n, 4.0), np.full(n, 1.8),
                             np.linspace(0, 3, n)])
    corners = pb.boxes2d_to_corners2d(boxes)
    scores = np.random.RandomState(14).rand(n)
    best = np.argsort(scores)[::-1]

    monkeypatch.setattr(jb, "rotated_iou", jn.rotated_iou)
    jax_numpy = jb.nms_rotated(corners, scores, 0.15)
    port_numpy = pn.nms_rotated(corners, scores, 0.15, route="numpy")
    np.testing.assert_array_equal(port_numpy, jax_numpy)
    np.testing.assert_array_equal(port_numpy, best[:1000])

    jax_native = jn.nms_rotated(corners, scores, 0.15)
    port_native = pn.nms_rotated(corners, scores, 0.15, route="native")
    np.testing.assert_array_equal(port_native, jax_native)
    np.testing.assert_array_equal(port_native, best)

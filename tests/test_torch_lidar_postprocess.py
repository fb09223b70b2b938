"""LiDAR post-processing and detection AP, port vs JAX.

The anchor targets at the cooperative LiDAR map's full 96 x 176 x 2 anchors
(``tools/benchmark.py:POINTPILLAR_RANGE``), the anchor decoder with its NMS,
the PIXOR-style BEV post-processor, detection AP on random detections and
the two ground-truth round trips of ``tools/debug_utils.py``, each on the
same numpy draws from a seed in ``cobevt_tpu`` and ``cobevt_tpu_torch``
(both on their native route).  Tolerance: targets, labels and kept sets
equal; NMS's kept indices exact; decoded corners and scores 1e-6
absolute; AP values equal.
"""

import dataclasses

import numpy as np
import pytest

from cobevt_tpu.geometry.boxes import boxes2d_to_corners2d
from cobevt_tpu.metrics import detection_ap as jap
from cobevt_tpu.postprocess import lidar_bev_postprocessor as jbev
from cobevt_tpu.postprocess import voxel_postprocessor as jpost
from cobevt_tpu.tools import debug_utils as jdebug
from cobevt_tpu.utils import native_ops as jnative
from cobevt_tpu_torch.metrics import detection_ap as pap
from cobevt_tpu_torch.postprocess import lidar_bev_postprocessor as pbev
from cobevt_tpu_torch.postprocess import voxel_postprocessor as ppost
from cobevt_tpu_torch.tools import debug_utils as pdebug
from cobevt_tpu_torch.tools.benchmark import POINTPILLAR_RANGE
from cobevt_tpu_torch.utils import native_ops

FULL = dict(cav_lidar_range=POINTPILLAR_RANGE, W=352, H=192,
            feature_stride=2)


def _gt(seed, n_valid, max_num=100):
    """hwl boxes on the ground inside the LiDAR range."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((max_num, 7))
    boxes[:, 0] = rng.uniform(-66, 66, max_num)
    boxes[:, 1] = rng.uniform(-34, 34, max_num)
    boxes[:, 2] = rng.uniform(-1.2, -0.8, max_num)
    boxes[:, 3] = rng.uniform(1.4, 1.7, max_num)
    boxes[:, 4] = rng.uniform(1.6, 2.0, max_num)
    boxes[:, 5] = rng.uniform(3.8, 4.8, max_num)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, max_num)
    mask = np.zeros(max_num)
    mask[:n_valid] = 1
    return boxes, mask


def _posts(**kw):
    return (jpost.VoxelPostprocessor(jpost.AnchorArgs(**FULL), **kw),
            ppost.VoxelPostprocessor(ppost.AnchorArgs(**FULL), **kw))


@pytest.mark.parametrize("seed,n_valid", [(0, 24), (1, 60), (2, 0)])
def test_generate_label_at_full_width_is_bit_equal(seed, n_valid):
    jp, pp = _posts()
    assert pp.anchors.shape == (96, 176, 2, 7)
    boxes, mask = _gt(seed, n_valid)
    before = native_ops.route_calls["bbox_overlaps"]["native"]
    want = jp.generate_label(boxes, mask)
    got = pp.generate_label(boxes, mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["targets"].shape == (96, 176, 14)
    assert native_ops.route_calls["bbox_overlaps"]["native"] == \
        before + (1 if n_valid else 0)


def test_delta_to_boxes3d_equals_the_jax_packages():
    jp, pp = _posts()
    deltas = np.random.RandomState(3).randn(2, 96, 176, 14) * 0.3
    np.testing.assert_array_equal(
        ppost.delta_to_boxes3d(deltas, pp.anchors),
        jpost.delta_to_boxes3d(deltas, jp.anchors))


@pytest.mark.parametrize("shift", [-3.0, -12.0])
def test_decode_at_full_width_equals_the_jax_packages(shift):
    """Random maps over the 33,792 anchors: ~5% of them over the score
    threshold (shift -3), or none (shift -12)."""
    jp, pp = _posts()
    rng = np.random.RandomState(4)
    cls = rng.randn(96, 176, 2) + shift
    reg = rng.randn(96, 176, 14) * 0.2
    before = native_ops.route_calls["nms_rotated"]["native"]
    want = jp.decode(cls, reg)
    got = pp.decode(cls, reg)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    if shift == -3.0:
        assert len(got[0]) == pp.max_num
        assert native_ops.route_calls["nms_rotated"]["native"] == before + 1
        # the kept indices of the candidates decode hands to NMS
        scores = 1 / (1 + np.exp(-cls.reshape(-1)))
        keep = scores > pp.score_threshold
        corners = ppost.boxes_to_corners_3d(
            ppost.delta_to_boxes3d(reg[None], pp.anchors)[0][keep],
            "hwl")[:, :4, :2]
        np.testing.assert_array_equal(
            native_ops.nms_rotated(corners, scores[keep], pp.nms_threshold),
            jnative.nms_rotated(corners, scores[keep], jp.nms_threshold))
    else:
        assert got[0].shape == (0, 8, 3)


def test_lidar_bev_postprocessor_equals_the_jax_packages():
    kw = dict(score_threshold=0.5, nms_threshold=0.15)
    jgeo = jbev.BevGeometry(L1=-20.0, W1=-20.0, res=0.4, downsample_rate=2,
                            label_shape=(50, 50, 7))
    pgeo = pbev.BevGeometry(**dataclasses.asdict(jgeo))
    jl, pl = jbev.LidarBevPostprocessor(jgeo, **kw), \
        pbev.LidarBevPostprocessor(pgeo, **kw)
    rng = np.random.RandomState(5)
    gt = np.zeros((8, 7))
    gt[:, 0:2] = rng.uniform(-15, 15, (8, 2))
    gt[:, 3] = rng.uniform(3.8, 4.6, 8)
    gt[:, 4] = rng.uniform(1.6, 2.0, 8)
    gt[:, 5] = 1.5
    gt[:, 6] = rng.uniform(-np.pi, np.pi, 8)
    mask = (np.arange(8) < 5).astype(float)
    want = jl.generate_label(gt, mask)["label_map"]
    got = pl.generate_label(gt, mask)["label_map"]
    np.testing.assert_array_equal(got, want)
    logits = np.where(want[..., 0] > 0, 10.0, -10.0) + \
        rng.randn(50, 50) * 0.1
    for a, b in zip(pl.decode(logits, want[..., 1:]),
                    jl.decode(logits, want[..., 1:])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pl.denormalize_reg_map(want[..., 1:]),
                                  jl.denormalize_reg_map(want[..., 1:]))


def test_detection_ap_equals_the_jax_packages():
    """Five frames of random ground truth and detections (jittered copies,
    duplicates and misses), accumulated at IoU 0.3, 0.5 and 0.7."""
    rng = np.random.RandomState(6)
    thresholds = (0.3, 0.5, 0.7)
    jstat, pstat = jap.new_result_stat(thresholds), \
        pap.new_result_stat(thresholds)
    for frame in range(5):
        n = rng.randint(3, 9)
        gt = np.column_stack([rng.uniform(-30, 30, (n, 2)),
                              rng.uniform(3.5, 4.5, n),
                              rng.uniform(1.6, 2.0, n),
                              rng.uniform(-3, 3, n)])
        det = np.concatenate([
            gt + rng.randn(n, 5) * [0.6, 0.6, 0.2, 0.1, 0.1],
            gt[:2] + 0.3, np.column_stack([rng.uniform(-30, 30, (3, 2)),
                                           np.full((3, 2), 3.0),
                                           np.zeros(3)])])
        scores = rng.rand(len(det))
        gc, dc = boxes2d_to_corners2d(gt), boxes2d_to_corners2d(det)
        for t in thresholds:
            jap.accumulate_tp_fp(dc, scores, gc, jstat, t)
            pap.accumulate_tp_fp(dc, scores, gc, pstat, t)
    assert pstat == jstat
    aps = []
    for t in thresholds:
        got, want = pap.calculate_ap(pstat, t), jap.calculate_ap(jstat, t)
        assert got == want
        aps.append(got[0])
    assert 0 < aps[2] < aps[1] < aps[0] < 1
    rec, prec = [0.2, 0.4, 0.4, 0.9], [1.0, 0.5, 0.66, 0.4]
    assert pap.voc_ap(rec, prec) == jap.voc_ap(rec, prec)
    assert pap.calculate_ap(pap.new_result_stat(), 0.5) == (0.0, [], [])


@pytest.mark.parametrize("seed,n_valid", [(7, 20), (8, 0)])
def test_debug_roundtrips_equal_the_jax_packages(seed, n_valid):
    """The anchor round trip at full width and the PIXOR round trip, on
    ground truth the decoders must give back."""
    jp, pp = _posts()
    boxes, mask = _gt(seed, n_valid)
    got = pdebug.check_anchor_roundtrip(pp, boxes, mask)
    assert got == jdebug.check_anchor_roundtrip(jp, boxes, mask)
    assert got

    geo = dict(L1=-20.0, W1=-20.0, res=0.4, downsample_rate=2,
               label_shape=(50, 50, 7))
    gt = np.zeros((5, 7))
    gt[0] = [1.0, 2.0, 0, 4.0, 2.0, 1.5, 0.4]
    gt[1] = [-8.0, -5.0, 0, 4.5, 1.8, 1.5, -1.0]
    m = (np.arange(5) < min(n_valid, 2)).astype(float)
    got = pdebug.check_pixor_roundtrip(
        pbev.LidarBevPostprocessor(pbev.BevGeometry(**geo),
                                   score_threshold=0.5), gt, m)
    assert got == jdebug.check_pixor_roundtrip(
        jbev.LidarBevPostprocessor(jbev.BevGeometry(**geo),
                                   score_threshold=0.5), gt, m)
    assert got

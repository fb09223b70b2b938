"""The LiDAR detection loss and target assignment of the port against the
JAX package.

``PointPillarLoss`` (focal classification over positive and negative anchors,
smooth-L1 regression with the sin-difference angle term) on the same numpy
predictions and labels: the loss parts to 1e-6 rel in f32, the gradients with
respect to both prediction maps against ``jax.grad`` to 1e-6 of the largest
gradient.  ``generate_anchor_box`` and ``VoxelPostprocessor.generate_label``
are numpy on both sides: the arrays must be equal (positive and negative maps)
or equal to 1e-12 (targets: the JAX package may take its IoU from the native
library, which changes no assignment here).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.losses.detection_loss import PointPillarLoss as JaxLoss
from cobevt_tpu.losses.detection_loss import smooth_l1 as jax_smooth_l1
from cobevt_tpu.losses.seg_losses import sigmoid_focal_loss as jax_focal
from cobevt_tpu.postprocess import voxel_postprocessor as jpost
from cobevt_tpu_torch.losses import (
    PointPillarLoss,
    sigmoid_focal_loss,
    smooth_l1,
)
from cobevt_tpu_torch.postprocess import voxel_postprocessor as ppost


def _loss_inputs(seed, n_pos=0.05):
    rng = np.random.RandomState(seed)
    B, H, W, A = 2, 6, 8, 2
    cls = rng.randn(B, H, W, A).astype(np.float32) * 2
    reg = rng.randn(B, H, W, A * 7).astype(np.float32)
    pos = (rng.rand(B, H, W, A) < n_pos).astype(np.float32)
    neg = ((1 - pos) * (rng.rand(B, H, W, A) < 0.9)).astype(np.float32)
    # small and large residuals, so both branches of smooth-L1 are taken
    tgt = (reg + rng.randn(*reg.shape) * rng.choice(
        [0.02, 1.0], reg.shape)).astype(np.float32)
    return cls, reg, pos, neg, tgt


@pytest.mark.parametrize("seed,n_pos", [(0, 0.05), (1, 0.3), (2, 0.0)])
def test_loss_and_gradients_match_jax(seed, n_pos):
    cls, reg, pos, neg, tgt = _loss_inputs(seed, n_pos)
    jloss = JaxLoss()

    def jfn(c, r):
        return jloss({"cls_preds": c, "reg_preds": r},
                     {"pos_equal_one": jnp.asarray(pos),
                      "neg_equal_one": jnp.asarray(neg),
                      "targets": jnp.asarray(tgt)})

    (want, parts), grads = jax.value_and_grad(jfn, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    tc = torch.from_numpy(cls).requires_grad_(True)
    tr = torch.from_numpy(reg).requires_grad_(True)
    got, gparts = PointPillarLoss()(
        {"cls_preds": tc, "reg_preds": tr},
        {"pos_equal_one": torch.from_numpy(pos),
         "neg_equal_one": torch.from_numpy(neg),
         "targets": torch.from_numpy(tgt)})
    got.backward()
    assert set(gparts) == set(parts) == {"cls_loss", "reg_loss", "total_loss"}
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for k in parts:
        np.testing.assert_allclose(float(gparts[k].detach()), float(parts[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for g, w in zip((tc.grad, tr.grad), grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-6))
    if n_pos == 0.0:
        assert float(pos.sum()) == 0 and float(gparts["reg_loss"]) == 0.0


def test_focal_loss_and_smooth_l1_elementwise():
    rng = np.random.RandomState(3)
    x = rng.randn(64).astype(np.float32) * 3
    t = (rng.rand(64) < 0.5).astype(np.float32)
    for alpha in (-1.0, 0.25):
        np.testing.assert_allclose(
            sigmoid_focal_loss(torch.from_numpy(x), torch.from_numpy(t),
                               alpha, 2.0).numpy(),
            np.asarray(jax_focal(jnp.asarray(x), jnp.asarray(t), alpha, 2.0)),
            rtol=2e-6, atol=1e-7)
    r = np.linspace(-0.5, 0.5, 41).astype(np.float32)
    np.testing.assert_allclose(smooth_l1(torch.from_numpy(r)).numpy(),
                               np.asarray(jax_smooth_l1(jnp.asarray(r))),
                               rtol=1e-6, atol=1e-8)


ANCHORS = dict(cav_lidar_range=(-12.8, -6.4, -3, 12.8, 6.4, 1), W=64, H=32)


@pytest.mark.parametrize("order", ["hwl", "lhw"])
def test_anchor_boxes_equal_the_jax_packages(order):
    want = jpost.generate_anchor_box(jpost.AnchorArgs(**ANCHORS), order)
    got = ppost.generate_anchor_box(ppost.AnchorArgs(**ANCHORS), order)
    assert got.shape == (16, 32, 2, 7)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ppost.generate_anchor_box(ppost.AnchorArgs(**ANCHORS), "whl")
    assert ppost.AnchorArgs() == ppost.AnchorArgs(
        **{f: getattr(jpost.AnchorArgs(), f) for f in
           ("cav_lidar_range", "l", "w", "h", "r", "vw", "vh", "W", "H",
            "feature_stride")})


def _boxes(seed, n_valid, max_num=12):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((max_num, 7))
    boxes[:, 0] = rng.uniform(-11, 11, max_num)
    boxes[:, 1] = rng.uniform(-5, 5, max_num)
    boxes[:, 2] = rng.uniform(-1.5, -0.5, max_num)
    boxes[:, 3] = rng.uniform(1.4, 1.8, max_num)      # h
    boxes[:, 4] = rng.uniform(1.5, 2.0, max_num)      # w
    boxes[:, 5] = rng.uniform(3.5, 4.8, max_num)      # l
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, max_num)
    mask = np.zeros(max_num)
    mask[:n_valid] = 1
    return boxes, mask


@pytest.mark.parametrize("seed,n_valid", [(0, 7), (1, 12), (2, 1), (3, 0)])
def test_generate_label_equals_the_jax_packages(seed, n_valid):
    boxes, mask = _boxes(seed, n_valid)
    want = jpost.VoxelPostprocessor(
        jpost.AnchorArgs(**ANCHORS)).generate_label(boxes, mask)
    got = ppost.VoxelPostprocessor(
        ppost.AnchorArgs(**ANCHORS)).generate_label(boxes, mask)
    assert set(got) == {"pos_equal_one", "neg_equal_one", "targets"}
    np.testing.assert_array_equal(got["pos_equal_one"], want["pos_equal_one"])
    np.testing.assert_array_equal(got["neg_equal_one"], want["neg_equal_one"])
    np.testing.assert_allclose(got["targets"], want["targets"], rtol=0,
                               atol=1e-12)
    assert got["targets"].shape == (16, 32, 14)
    if n_valid:
        # every box has at least its best anchor, and no anchor is both
        assert got["pos_equal_one"].sum() >= 1
        assert float((got["pos_equal_one"] * got["neg_equal_one"]).sum()) == 0
    else:
        assert got["pos_equal_one"].sum() == 0 and got["neg_equal_one"].all()


def test_helpers_equal_the_jax_packages_numpy_versions():
    from cobevt_tpu.geometry import boxes as jboxes
    boxes, _ = _boxes(5, 12)
    np.testing.assert_array_equal(
        ppost.boxes_to_corners_3d(boxes, "hwl"),
        jboxes.boxes_to_corners_3d(boxes, "hwl"))
    a = ppost.corner2d_to_standup(ppost.boxes_to_corners_3d(boxes, "hwl"))
    np.testing.assert_array_equal(
        a, jpost.corner2d_to_standup(jboxes.boxes_to_corners_3d(boxes,
                                                                "hwl")))
    np.testing.assert_array_equal(ppost.bbox_overlaps(a, a[:5]),
                                  jboxes.bbox_overlaps(a, a[:5]))

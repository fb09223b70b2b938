"""Port losses and IoU metrics against the JAX package, f32 on the CPU.

Inputs come from numpy seeds and go to both sides.  Tolerance 1e-6 abs /
1e-5 rel for the losses (log-softmax and a weighted mean in another order);
the IoU counters are integers and compare exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.losses import seg_losses as jl
from cobevt_tpu.metrics import iou as jm
from cobevt_tpu_torch.losses import seg_losses as pl
from cobevt_tpu_torch.metrics import iou as pm

TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_cross_entropy_value_and_gradient(masked):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 1, 6, 5, 3).astype(np.float32) * 2
    labels = rng.randint(0, 3, (2, 1, 6, 5))
    weights = [1.0, 15.0, 50.0]
    valid = (rng.rand(2, 1, 6, 5) > 0.4).astype(np.float32) if masked \
        else None

    def jloss(x):
        return jl.weighted_cross_entropy(
            x, jnp.asarray(labels), jnp.asarray(weights),
            None if valid is None else jnp.asarray(valid))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = pl.weighted_cross_entropy(
        x, torch.from_numpy(labels), weights,
        None if valid is None else torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)


def test_weighted_cross_entropy_all_masked_is_finite():
    x = torch.randn(2, 3, 4)
    got = pl.weighted_cross_entropy(x, torch.zeros(2, 3, dtype=torch.long),
                                    [1.0, 2.0, 3.0, 4.0],
                                    torch.zeros(2, 3))
    assert float(got) == 0.0


@pytest.mark.parametrize("target", ["dynamic", "static", "both"])
def test_vanilla_seg_loss(target):
    rng = np.random.RandomState(1)
    out = {"dynamic_seg": rng.randn(2, 1, 8, 8, 2).astype(np.float32),
           "static_seg": rng.randn(2, 1, 8, 8, 3).astype(np.float32)}
    gt = {"gt_dynamic": rng.randint(0, 2, (2, 1, 8, 8)),
          "gt_static": rng.randint(0, 3, (2, 1, 8, 8))}
    kw = dict(target=target, d_weights=75.0, s_weights=15.0, l_weights=50.0,
              d_coe=2.0, s_coe=0.5)
    want, want_parts = jl.VanillaSegLoss(**kw)(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in gt.items()})
    got, parts = pl.VanillaSegLoss(**kw)(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in gt.items()})
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(parts) == set(want_parts)
    for k in want_parts:
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   **TOL)


@pytest.mark.parametrize("case", ["plain", "visibility", "label_indices"])
def test_iou_update_and_compute(case):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 6, 7, 2).astype(np.float32)
    kw = {}
    if case == "label_indices":
        label = rng.rand(2, 6, 7, 5).astype(np.float32)
        kw["label_indices"] = [[0, 1], [2, 3, 4]]
    else:
        label = rng.randint(0, 2, (2, 6, 7, 2)).astype(np.float32)
    vis = rng.randint(0, 4, (2, 6, 7))
    if case == "visibility":
        kw["min_visibility"] = 2
    js, ps = jm.IoUState.create(2, 2), pm.IoUState.create(2, 2)
    for _ in range(2):                           # states accumulate
        js = jm.iou_update(js, jnp.asarray(logits), jnp.asarray(label),
                           visibility=jnp.asarray(vis), **kw)
        ps = pm.iou_update(ps, torch.from_numpy(logits),
                           torch.from_numpy(label),
                           visibility=torch.from_numpy(vis), **kw)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(pm.iou_compute(ps).numpy(),
                               np.asarray(jm.iou_compute(js)), rtol=1e-6)


def test_confusion_and_mean_iou():
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 3, (2, 9, 9))
    gt = rng.randint(0, 3, (2, 9, 9))
    want = jm.confusion_counts(jnp.asarray(pred), jnp.asarray(gt), 3)
    got = pm.confusion_counts(torch.from_numpy(pred), torch.from_numpy(gt), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(pm.per_class_iou(got).numpy(),
                               np.asarray(jm.per_class_iou(want)), rtol=1e-6)
    gt1 = gt[0].copy()
    gt1[gt1 == 2] = 0                            # class 2 absent from GT
    assert pm.mean_iou_reference(pred[0], gt1, 3) == \
        jm.mean_iou_reference(pred[0], gt1, 3)
    assert pm.mean_iou_reference(pred[0], gt1, 3)[2] == 0.0

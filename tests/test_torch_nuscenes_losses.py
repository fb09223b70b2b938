"""The nuScenes losses, criterion and one-cycle schedule of the port
against the JAX package, f32 on the CPU.

The same numpy logits and labels (12 binary label channels, a centerness
map in [0, 1], visibility levels 0-4, as the nuScenes generator gives them)
go through ``cobevt_tpu.losses.seg_losses`` and the port's
``losses/seg_losses.py``: ``BinarySegmentationLoss``, ``CenterLoss`` and
``MultipleLoss`` over min_visibility (None, 2), label_indices (None, the
vehicle group) and alpha (-1, 0.25), an all-invisible mask (the 1e-12 clamp
of the masked mean: 0, not NaN), the criterion of both pyramid-axial
presets, and the gradient of the criterion with respect to the logits.
Tolerance 1e-6 abs / 1e-5 rel: the same f32 elementwise arithmetic, means
over 2 x 16 x 16 pixels in another order.  The one-cycle schedule is held to
``optax.cosine_onecycle_schedule`` at step 0, at both phase boundaries and
next to them, at the last step and past it (optax computes in f32: 1e-6 rel,
and 2e-7 abs, two f32 ulps at 1, at unit peak), and shown to differ from
``torch.optim.lr_scheduler.OneCycleLR``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from cobevt_tpu.configs import nuscenes_experiments as jexp
from cobevt_tpu.losses import seg_losses as jl
from cobevt_tpu_torch.configs import nuscenes_experiments as pexp
from cobevt_tpu_torch.losses import seg_losses as pl
from cobevt_tpu_torch.train import onecycle_schedule

TOL = dict(atol=1e-6, rtol=1e-5)
VEHICLE = pexp.VEHICLE_LABELS
B, H, W = 2, 16, 16


def make_data(seed=0, invisible=False):
    rng = np.random.RandomState(seed)
    vis = rng.randint(0, 5, (B, H, W))
    if invisible:
        vis[:] = rng.randint(0, 2, (B, H, W))     # every pixel below 2
    return {"bev_logits": (rng.randn(B, H, W, 1) * 2).astype(np.float32),
            "center_logits": (rng.randn(B, H, W, 1) * 2).astype(np.float32),
            "bev": (rng.rand(B, H, W, 12) < 0.2).astype(np.float32),
            "center": rng.rand(B, H, W, 1).astype(np.float32),
            "visibility": vis}


def _sides(d):
    pred_t = {"bev": torch.from_numpy(d["bev_logits"]),
              "center": torch.from_numpy(d["center_logits"])}
    pred_j = {k: jnp.asarray(v.numpy()) for k, v in pred_t.items()}
    batch_t = {k: torch.from_numpy(d[k]) for k in ("bev", "center",
                                                   "visibility")}
    batch_j = {k: jnp.asarray(d[k]) for k in ("bev", "center", "visibility")}
    return pred_t, batch_t, pred_j, batch_j


def _close(got, want, name=""):
    np.testing.assert_allclose(float(got.detach() if torch.is_tensor(got)
                                     else got), float(want), err_msg=name,
                               **TOL)


@pytest.mark.parametrize("invisible", [False, True])
@pytest.mark.parametrize("alpha", [-1.0, 0.25])
@pytest.mark.parametrize("labels", [None, VEHICLE])
@pytest.mark.parametrize("min_visibility", [None, 2])
def test_binary_segmentation_loss_matches_jax(min_visibility, labels, alpha,
                                              invisible):
    d = make_data(invisible=invisible)
    if labels is None:
        d["bev"] = d["bev"][..., :1]        # one label channel, one logit
    pred_t, batch_t, pred_j, batch_j = _sides(d)
    kw = dict(label_indices=labels, min_visibility=min_visibility,
              alpha=alpha)
    got = pl.BinarySegmentationLoss(**kw)(pred_t, batch_t)
    want = jl.BinarySegmentationLoss(**kw)(pred_j, batch_j)
    assert got.dtype == torch.float32 and torch.isfinite(got)
    _close(got, want)
    if invisible and min_visibility is not None:
        assert float(got) == 0.0            # no kept pixel: 0 over 1e-12


@pytest.mark.parametrize("invisible", [False, True])
@pytest.mark.parametrize("alpha", [-1.0, 0.25])
@pytest.mark.parametrize("min_visibility", [None, 2])
def test_center_loss_matches_jax(min_visibility, alpha, invisible):
    pred_t, batch_t, pred_j, batch_j = _sides(make_data(1, invisible))
    kw = dict(min_visibility=min_visibility, alpha=alpha)
    got = pl.CenterLoss(**kw)(pred_t, batch_t)
    _close(got, jl.CenterLoss(**kw)(pred_j, batch_j))
    if invisible and min_visibility is not None:
        assert float(got) == 0.0


def test_multiple_loss_returns_total_and_unweighted_parts():
    pred_t, batch_t, pred_j, batch_j = _sides(make_data(2))

    def build(m):
        return m.MultipleLoss(
            losses=(("bev", m.BinarySegmentationLoss(VEHICLE, 2)),
                    ("center", m.CenterLoss(2)),
                    ("plain", m.CenterLoss())),
            weights=(("bev", 1.0), ("center", 0.1)))   # "plain" weighs 1

    total, parts = build(pl)(pred_t, batch_t)
    total_j, parts_j = build(jl)(pred_j, batch_j)
    assert set(parts) == set(parts_j) == {"bev", "center", "plain"}
    for k in parts:
        _close(parts[k], parts_j[k], k)
    _close(total, total_j)
    _close(total, parts["bev"] + 0.1 * parts["center"] + parts["plain"])


def test_losses_compute_in_the_logits_dtype():
    """The labels are cast to the logits' dtype, as in the JAX criterion:
    bf16 logits give a bf16 loss."""
    pred_t, batch_t, _, _ = _sides(make_data(3))
    pred_bf = {k: v.bfloat16() for k, v in pred_t.items()}
    crit = pexp.build_criterion(pexp.nuscenes_experiment(
        "cvt_pyramid_axial_nuscenes_vehicle"))
    total, parts = crit(pred_bf, batch_t)
    assert total.dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 for v in parts.values())


@pytest.mark.parametrize("name", ["cvt_pyramid_axial_nuscenes_vehicle",
                                  "cvt_pyramid_axial_nuscenes_road"])
def test_criterion_of_each_preset_matches_jax(name):
    """``build_criterion`` of both pyramid-axial presets on the same logits:
    vehicle (visibility-masked focal on the vehicle group + 0.1 x the
    masked center loss) and road (unmasked focal on the road group); the
    loss and its gradient with respect to each logit map."""
    pred_t, batch_t, pred_j, batch_j = _sides(make_data(4))
    crit_t = pexp.build_criterion(pexp.nuscenes_experiment(name))
    crit_j = jexp.build_criterion(jexp.nuscenes_experiment(name))
    assert [n for n, _ in crit_t.losses] == [n for n, _ in crit_j.losses]
    assert crit_t.weights == crit_j.weights
    leaves = {k: v.clone().requires_grad_() for k, v in pred_t.items()}
    total, parts = crit_t(leaves, batch_t)
    (total_j, parts_j), grads_j = jax.value_and_grad(
        lambda p: crit_j(p, batch_j), has_aux=True)(pred_j)
    _close(total, total_j)
    for k in parts_j:
        _close(parts[k], parts_j[k], k)
    total.backward()
    for k, g in grads_j.items():
        got = leaves[k].grad
        got = torch.zeros_like(leaves[k]) if got is None else got
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-8,
                                   rtol=1e-5, err_msg=k)


def test_unknown_loss_kind_raises():
    exp = pexp.nuscenes_experiment("cvt_pyramid_axial_nuscenes_road")
    bad = exp.__class__(**{**exp.__dict__, "losses": (
        ("x", pexp.LossSpec("dice")),)})
    with pytest.raises(ValueError, match="dice"):
        pexp.build_criterion(bad)


STEPS = 50001           # the nuScenes recipe's steps


@pytest.mark.parametrize("step", [0, 1, 14999, 15000, 15001, 30000, 50000,
                                  50001, 60000])
def test_onecycle_schedule_matches_optax(step):
    """The recipe's schedule (lr 5e-3 over 50,001 steps, pct_start 0.3,
    div_factor 10, final_div_factor 10) at step 0, next to and at both phase
    boundaries (int(0.3 * 50001) = 15000 and 50001), and past the end."""
    want = optax.cosine_onecycle_schedule(STEPS, 5e-3, 0.3, 10.0, 10.0)
    got = onecycle_schedule(5e-3, STEPS)
    np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                               atol=0)


def test_onecycle_schedule_is_not_torch_onecyclelr():
    """``torch.optim.lr_scheduler.OneCycleLR`` ends its phases a step
    earlier and at another final value; the port follows optax."""
    total = 100
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    torch_sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=1.0, total_steps=total, pct_start=0.3,
        div_factor=10.0, final_div_factor=10.0, anneal_strategy="cos",
        cycle_momentum=False)
    torch_lrs = []
    for _ in range(total):
        torch_lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        torch_sched.step()
    ours = onecycle_schedule(1.0, total)
    want = optax.cosine_onecycle_schedule(total, 1.0, 0.3, 10.0, 10.0)
    np.testing.assert_allclose([ours(s) for s in range(total + 1)],
                               [float(want(s)) for s in range(total + 1)],
                               rtol=1e-6, atol=2e-7)   # optax's f32 ulps
    assert ours(30) == pytest.approx(1.0) and torch_lrs[30] < 1.0
    assert ours(total) == pytest.approx(1e-2)
    assert torch_lrs[-1] == pytest.approx(1e-2, rel=1e-2)  # at total - 1
    assert abs(ours(total - 1) - torch_lrs[-1]) > 1e-6

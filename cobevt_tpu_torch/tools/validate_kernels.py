"""On-card gates: the int8 serving mode against the stock path, the fused
LiDAR forward against the stock one, and the training backward (K1 + K5)
against stock autograd.

**int8 gate** (``--model corpbevt``, the default; the int8 part of the forward
gate of ``cobevt_tpu/tools/validate_kernels.py``): the CorpBEVT eval forward
at ``corpbevt.yaml`` width under ``COBEVT_INT8=1`` (K7 for the blocks of 256
and 512 channels, layer1 int8-resident, everything else the serving default)
against the stock path (``COBEVT_FUSED_CONV``, ``COBEVT_FUSED_XATTN`` and
``COBEVT_FUSED_FUSION`` all "0", no int8), same weights and batch.  Three
checks: every output's largest deviation over the stock output's largest value
within :data:`BUDGET_INT8`; the argmax IoU of ``dynamic_seg`` and
``static_seg`` at least 0.99 (what a user of a lossy mode sees, meaningful
even with random weights); and the largest share of values that the static
scale schedule of the int8-resident blocks clipped at most 1%, so weights
outside the schedule show instead of saturating silently.

  python -m cobevt_tpu_torch.tools.validate_kernels

**Forward gate** (``--model pointpillar``; the forward gate of
``cobevt_tpu/tools/validate_kernels.py`` for that model): the cooperative
LiDAR eval forward at full width, once with FuseBEVT as K6
(``COBEVT_FUSED_FUSION=force-stream``, 4 launches; the default takes K6
at this map too) and once with
``COBEVT_FUSED_FUSION=0`` (the stock modules, 4 K1 launches), same weights
and batch; every output's largest deviation over the stock output's largest
value must stay within :data:`BUDGET_FORWARD`.

  python -m cobevt_tpu_torch.tools.validate_kernels --model pointpillar

**SinBEVT forward gate** (``--model sinbevt``; the forward gate of
``cobevt_tpu/tools/validate_kernels.py`` for the nuScenes flagship): the
full-width ``cvt_pyramid_axial_nuscenes_vehicle`` eval forward (EfficientNet-b4,
6 cameras x 224 x 480, BEV 200^2) at each of ``--seeds`` (weights and
nothing else drawn from the seed), three times on the same batch: in bf16
on the serving default (K2 for every cross-view branch), in bf16 on the
stock path (``COBEVT_FUSED_XATTN=0``: K1), and in f32 on the plain versions
of every kernel (``forced_impl("torch")``, the serving default's dispatch).
Two comparisons, bf16 default against f32 plain and default against stock,
each with three checks: per output the largest deviation over the
reference's largest value within :data:`BUDGET_SINBEVT`; on ``bev`` the IoU
of the two sign-of-logit maps (mean over the two classes, as
``argmax_iou``) at least 0.99, and the same IoU taken about the reference's
median at least :data:`SINBEVT_CENTERED_IOU_FLOOR` (at random weights the
map may hold one sign everywhere).  Then, at seed 0, the gate again with
each fault of :data:`SINBEVT_FAULTS` planted in one K2 or one K1 call: it
must fail on a dropped head; a wrong softmax scale is read and reported
(at random weights it moves the frame less than bf16 does).

  python -m cobevt_tpu_torch.tools.validate_kernels --model sinbevt

**Gradient gate** (``--train``; ``validate_train`` of the JAX tool): loss and
gradients of one train forward and backward at full width in bf16, once on
the shipped path (K1 forward, K5 flash backward) and once with
``COBEVT_FLASH_BWD=0`` (the plain attention under stock autograd), same
weights, batch and dropout seed.  It compares the loss, the global gradient
norm and every parameter's gradient norm, and also prints the drift against
the ``COBEVT_FLASH_BWD_F32=1`` control (the composite backward with f32
epilogue).  ``--model corpbevt`` (the default) gates the camera step at
``corpbevt.yaml`` width, ``--model pointpillar`` the cooperative-LiDAR step
(detection loss, K5 over whole 320-token windows with the communication
mask).  The LiDAR gate adds a gradient-truth check at a small width, so that
it does not hold noise against noise only: both bf16 paths against the f32
plain path, as the relative L2 distance over all gradients.

  python -m cobevt_tpu_torch.tools.validate_kernels --train
  python -m cobevt_tpu_torch.tools.validate_kernels --train --model pointpillar

Needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models import fax
from cobevt_tpu_torch.models.lidar.point_pillar_models import (
    PointPillarConfig,
)
from cobevt_tpu_torch.nn.resnet import ResNetTrunk
from cobevt_tpu_torch.ops.dispatch import env_switches, forced_impl
from cobevt_tpu_torch.ops.fused_cross_attention import PackedParams
from cobevt_tpu_torch.tools.benchmark import (
    BUILD_MODEL,
    build_corpbevt,
    build_pointpillar,
    build_sinbevt,
    make_criterion,
)

# Budgets of the gate: relative drift of loss and global gradient norm,
# relative drift of one parameter's gradient norm, and the share of the
# global norm a parameter's deviation must reach to count (materiality).
# Each is about 3x the drift measured on an NVIDIA H100 80GB HBM3 (700 W) at
# corpbevt.yaml width in bf16 over two seeds (the JAX package's 2% / 6% / 1%
# were calibrated on a TPU): loss 2.6e-4, global norm 3.0e-3, the worst
# layer among those of at least a tenth of the global norm 2.5e-2, the
# largest single deviation 3.4e-3 of the global norm.  Tight enough that a
# wrong flash identity, a dropped cast or a stale residual trips them.
BUDGET_SCALAR = 0.01
BUDGET_LAYER = 0.075
MATERIAL_FRAC = 0.01
# The LiDAR step's budgets (scalar, per layer, materiality), set the same way
# at full LiDAR width in bf16 on the same card, 3 to 5 times the larger of
# seeds 0 and 1: loss 0 and 0 (the forward is K1 on both paths), global norm
# 3.9e-6 and 1.8e-5, the worst signal-tier layer 4.3e-3 and 3.9e-3, the
# largest single deviation 1.1e-4 and 5.3e-5 of the global norm.  The two
# paths differ only in the rounding of four attention backwards, so the drift
# is far below the camera step's.  The JAX package's 10% / 50% / 2% bound a
# TPU's bf16 noise band and would let a wrong backward through here.
TRAIN_BUDGETS = {
    "corpbevt": (BUDGET_SCALAR, BUDGET_LAYER, MATERIAL_FRAC),
    "pointpillar": (1e-4, 0.015, 5e-4),
}
# The gradient-truth check of the LiDAR gate: a narrow model (fused width 128,
# 16 x 16 map, 2 agents, dropout 0, so that f32 and bf16 draw nothing
# different), every gradient of both bf16 paths against the f32 plain path.
# Measured on an NVIDIA H100 80GB HBM3 (700 W): relative L2 distance over all
# gradients 0.0945 (K5 path) and 0.0950 (stock) at seed 0, 0.0981 and 0.0990
# at seed 1: bf16 itself, not the kernels, sets the distance (the detection
# loss at random weights is cancellation-dominated).  The bound is 3x that.
TRUTH_CONFIG = dict(
    max_cav=2, point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0),
    max_voxels=96, max_points_per_voxel=8, pillar_filters=(16,),
    layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(16, 32),
    upsample_strides=(1, 2), num_upsample_filter=(16, 16), shrink_dim=128,
    fusion_mlp_dim=256, fusion_depth=1, fusion_dropout=0.0)
BUDGET_TRUTH = 0.3


# Budget of the forward gate: max |fused - stock| over max |stock|, per
# output.  About 3x the drift measured on an NVIDIA H100 80GB HBM3 (700 W)
# at full LiDAR width in bf16 over seeds 0 and 1 and 5, 3, 1, 4, 2 live
# agents: K6 against the stock path 0.0075..0.0133 (one or two bf16 ulps of
# a logit near 2.4), the bf16 kernel path against the f32 plain path 0.0120
# and 0.0126.  The JAX package's 5% was set on a TPU.
BUDGET_FORWARD = 0.04


# Budget of the int8 gate: max |int8 - stock| over max |stock|, per output.
# About 3x the drift measured on an NVIDIA H100 80GB HBM3 (700 W) at
# corpbevt.yaml width in bf16: 0.0324 at seed 0 and 0.0479 at seed 1 (about
# eight bf16 ulps of logits that stay below 0.3 at random weights; argmax IoU
# 1.0 and 0.9971, no value clipped).  The JAX package's 6% was set on a TPU.
BUDGET_INT8 = 0.15
INT8_IOU_KEYS = ("dynamic_seg", "static_seg")
INT8_IOU_FLOOR = 0.99
INT8_SAT_BUDGET = 0.01


# Budgets of the SinBEVT forward gate, set from readings on an NVIDIA H100
# 80GB HBM3 (700 W) at full width, sound over seeds 0-4 and with each
# planted fault at seed 0.  Drift (max |x - ref| over max |ref|, per
# output): sound, bf16 default vs f32 plain 0.023-0.039, default vs stock
# 0.026-0.048 (the center logits, rounded to bf16 after each of the trunk's
# layers); one dropped head in K2 or K1 0.46-0.53; the budget sits between,
# 3x the sound largest and a third of the faulted smallest.  At random
# weights the bev logits keep one sign on all but a few pixels (positive
# share 0 to 2.5e-5, or 0.9998), so the sign IoU (floor 0.99) is 1.0
# whatever the map holds, a dropped head included; taken about the
# reference's median it read 0.889-0.947 sound and 0.53-0.55 with a
# dropped head, and its floor sits between.
BUDGET_SINBEVT = 0.15
SINBEVT_CENTERED_IOU_FLOOR = 0.75
SINBEVT_IOU_KEYS = ("bev",)
SINBEVT_SEEDS = (0, 1, 2, 3, 4)


def argmax_iou(a, b) -> float:
    """Mean over classes of the IoU between the argmax maps of two logit
    tensors (classes last): ``argmax_iou`` of the JAX tool."""
    a, b = a.argmax(-1), b.argmax(-1)
    ious = []
    for c in torch.unique(torch.cat([a.flatten(), b.flatten()])):
        union = ((a == c) | (b == c)).sum()
        if union:
            ious.append(float(((a == c) & (b == c)).sum() / union))
    return float(np.mean(ious)) if ious else 1.0


def compare_outputs(name, fused, stock, budget: float, iou_keys=(),
                    iou_floor: float = INT8_IOU_FLOOR) -> dict:
    """``compare`` of the JAX tool: per output the largest absolute
    deviation and its share of the stock output's largest value; ok when
    every share is within ``budget``, everything is finite and every output
    named in ``iou_keys`` keeps an argmax IoU of at least ``iou_floor``."""
    outputs = {}
    ious = {}
    ok = True
    for key, s in stock.items():
        f, s = fused[key].float(), s.float()
        adiff = float((f - s).abs().max())
        rel = adiff / (float(s.abs().max()) + 1e-9)
        finite = bool(torch.isfinite(f).all() and torch.isfinite(s).all())
        ok = ok and finite and rel <= budget
        outputs[key] = {"abs": adiff, "rel": rel}
        if key in iou_keys:
            ious[key] = argmax_iou(f, s)
            ok = ok and ious[key] >= iou_floor
    report = {"component": name, "ok": ok,
              "max_rel": max(o["rel"] for o in outputs.values()),
              "budget": budget, "outputs": outputs}
    if ious:
        report.update(argmax_iou=ious, iou_floor=iou_floor)
    return report


STOCK_SWITCHES = dict(COBEVT_FUSED_CONV="0", COBEVT_FUSED_XATTN="0",
                      COBEVT_FUSED_FUSION="0", COBEVT_INT8=None,
                      COBEVT_INT8_RESIDENT=None)
INT8_SWITCHES = dict(COBEVT_FUSED_CONV=None, COBEVT_FUSED_XATTN=None,
                     COBEVT_FUSED_FUSION=None, COBEVT_INT8="1",
                     COBEVT_INT8_RESIDENT=None)


def int8_forward(model, batch):
    """One eval forward under ``COBEVT_INT8=1`` with the clipped shares of
    the int8-resident blocks collected: (outputs, launch counts, shares)."""
    trunks = [m for m in model.modules() if isinstance(m, ResNetTrunk)]
    for trunk in trunks:
        trunk.collect_int8_sat = True
    try:
        with env_switches(**INT8_SWITCHES), torch.no_grad():
            ops.reset_launch_counts()
            out = model(batch)
            counts = ops.launch_counts()
        sats = [float(s) for trunk in trunks for s in trunk.int8_sat_fracs]
    finally:
        for trunk in trunks:
            trunk.collect_int8_sat = False
            trunk.int8_sat_fracs = []
    return out, counts, sats


def compare_int8(quant, stock, sats, budget: float = BUDGET_INT8) -> dict:
    """The int8 gate's report from the two forwards' outputs and the
    clipped shares."""
    report = compare_outputs("corpbevt_int8_ptq", quant, stock, budget,
                             iou_keys=INT8_IOU_KEYS)
    max_sat = max(sats) if sats else 0.0
    report["saturation"] = {"ok": max_sat <= INT8_SAT_BUDGET,
                            "max_sat_frac": max_sat,
                            "budget": INT8_SAT_BUDGET,
                            "blocks_sampled": len(sats)}
    report["ok"] = report["ok"] and report["saturation"]["ok"]
    return report


def validate_int8(device, bf16: bool = True, seed: int = 0, config=None,
                  max_cav: int = 5) -> dict:
    """Run the CorpBEVT eval forward on the stock path and under
    ``COBEVT_INT8=1`` and return the gate's report, with the launch counts of
    the int8 run."""
    model, batch, _ = build_corpbevt(max_cav, seed, device, config)
    model = model.eval()
    if bf16:
        model = model.to(torch.bfloat16)
    with env_switches(**STOCK_SWITCHES), torch.no_grad():
        stock = model(batch)
    quant, counts, sats = int8_forward(model, batch)
    report = compare_int8(quant, stock, sats)
    report["precision"] = "bf16" if bf16 else "fp32"
    report["seed"] = seed
    report["launches"] = counts
    return report


def validate_forward(device, bf16: bool = True, seed: int = 0,
                     config=None, max_cav: int = 5) -> dict:
    """Run the LiDAR eval forward on the fused and the stock FuseBEVT path
    and return the gate's report, with each path's launch counts."""
    model, batch, _ = build_pointpillar(max_cav, seed, device, config)
    model = model.eval()
    if bf16:
        model = model.to(torch.bfloat16)
    runs = {}
    for path, switch in (("fused", "force-stream"), ("stock", "0")):
        with env_switches(COBEVT_FUSED_FUSION=switch), torch.no_grad():
            ops.reset_launch_counts()
            out = model(batch)
            runs[path] = (out, ops.launch_counts())
    report = compare_outputs("pointpillar_fused_vs_stock", runs["fused"][0],
                             runs["stock"][0], BUDGET_FORWARD)
    report["precision"] = "bf16" if bf16 else "fp32"
    report["seed"] = seed
    report["launches"] = {path: counts for path, (_, counts) in runs.items()}
    return report


def sign_logits(out: dict) -> dict:
    """Each output as two-class scores (0, logit), so that ``argmax_iou`` is
    the IoU of the sign-of-logit maps, averaged over both signs."""
    return {k: torch.stack([torch.zeros_like(v), v], dim=-1)
            for k, v in out.items()}


def centered_sign_iou(a, b) -> float:
    """The sign IoU of ``a`` and ``b`` taken about the median of ``b``: at
    random weights a logit map may keep one sign everywhere, which makes
    the plain sign IoU 1 whatever the map holds; about the median each
    sign covers half the reference."""
    m = b.float().median()
    return argmax_iou(*(sign_logits({"x": t.float() - m})["x"]
                        for t in (a, b)))


def _drop_k2_head(real, *args, params, n_heads, **kwargs):
    """K2 with its first head's output dropped: the output projection's
    columns of that head zeroed."""
    params = PackedParams(params)
    dh = params["wo_t"].shape[1] // n_heads
    params["wo_t"] = params["wo_t"].clone()
    params["wo_t"][:, :dh] = 0
    return real(*args, params=params, n_heads=n_heads, **kwargs)


def _k2_width_scale(real, *args, scale, n_heads, **kwargs):
    """K2 with the softmax scale of the whole width, (heads * dh)^-0.5,
    in place of a head's."""
    return real(*args, scale=scale * n_heads ** -0.5, n_heads=n_heads,
                **kwargs)


def _drop_k1_head(real, q, k, v, n_heads, **kwargs):
    """K1 with its first head's output zeroed."""
    out = real(q, k, v, n_heads, **kwargs).clone()
    out[..., :out.shape[-1] // n_heads] = 0
    return out


def _k1_width_scale(real, q, k, v, n_heads, **kwargs):
    """K1 fed queries scaled by the whole width's (heads * dh)^-0.5 in
    place of a head's."""
    return real(q * n_heads ** -0.5, k, v, n_heads, **kwargs)


# Faults planted in one call a frame on the gate's bf16 runs, to show what
# its budgets catch: (the wrapper as models/fax.py calls it, the fault,
# whether the gate must fail on it).  The call is the frame's fifth, stage
# 2's local branch (4 heads; K2 on its wgmma route, or K1 at Tq 625 on the
# stock path), so a K2 fault shows on both comparisons and a K1 fault on
# default vs stock only.  A wrong softmax scale read within the sound range
# on the H100 (drift 0.040-0.048, IoU about the median 0.924-0.933): at
# random weights the attention rows are near uniform, so no budget on the
# frame can see it; phase 3 of chip_smoke.py holds each kernel's scale
# against its plain version.
SINBEVT_FAULTS = {
    "k2_dropped_head": ("fused_cross_view_attention", _drop_k2_head, True),
    "k2_width_scale": ("fused_cross_view_attention", _k2_width_scale, False),
    "k1_dropped_head": ("fused_window_attention_packed", _drop_k1_head,
                        True),
    "k1_width_scale": ("fused_window_attention_packed", _k1_width_scale,
                       False),
}
SINBEVT_FAULT_CALL = 4


@contextlib.contextmanager
def planted_fault(name):
    """While open, the ``SINBEVT_FAULT_CALL``-th call (from 0) of the
    wrapper that fault ``name`` names runs with the fault; None plants
    nothing."""
    if name is None:
        yield
        return
    attr, fault, _ = SINBEVT_FAULTS[name]
    real, calls = getattr(fax, attr), [0]

    def wrapped(*args, **kwargs):
        calls[0] += 1
        if calls[0] - 1 == SINBEVT_FAULT_CALL:
            return fault(real, *args, **kwargs)
        return real(*args, **kwargs)

    setattr(fax, attr, wrapped)
    try:
        yield
    finally:
        setattr(fax, attr, real)


def validate_sinbevt(device, seeds=SINBEVT_SEEDS, config=None,
                     budget: float = BUDGET_SINBEVT, fault=None) -> dict:
    """The SinBEVT forward gate at each seed: bf16 serving default against
    the f32 plain path and against the bf16 stock path, with each run's
    launch counts and the share of positive ``bev`` logits (how much of
    the map the sign IoU weighs).  ``fault``: a key of
    :data:`SINBEVT_FAULTS` planted in both bf16 runs."""
    reports = []
    for seed in seeds:
        model, batch, _ = build_sinbevt(seed=seed, device=device,
                                        config=config)
        model = model.eval()
        runs = {}
        with env_switches(COBEVT_FUSED_XATTN=None), torch.no_grad(), \
                forced_impl("torch"):
            ops.reset_launch_counts()
            runs["f32_plain"] = (model(batch), ops.launch_counts())
        model = model.to(torch.bfloat16)
        for path, switch in (("default", None), ("stock", "0")):
            with env_switches(COBEVT_FUSED_XATTN=switch), torch.no_grad(), \
                    planted_fault(fault):
                ops.reset_launch_counts()
                runs[path] = (model(batch), ops.launch_counts())
        ref, default = runs["f32_plain"][0], runs["default"][0]
        report = {"seed": seed,
                  "launches": {p: c for p, (_, c) in runs.items()},
                  "bev_positive_share": {
                      p: float((o["bev"] > 0).float().mean())
                      for p, (o, _) in runs.items()}}
        for name, a, b in (("bf16_default_vs_f32_plain", default, ref),
                           ("default_vs_stock", default, runs["stock"][0])):
            r = compare_outputs(name, sign_logits(a), sign_logits(b), budget,
                                iou_keys=SINBEVT_IOU_KEYS)
            r["centered_bev_iou"] = centered_sign_iou(a["bev"], b["bev"])
            r["ok"] = r["ok"] and \
                r["centered_bev_iou"] >= SINBEVT_CENTERED_IOU_FLOOR
            report[name] = r
        report["ok"] = all(report[n]["ok"] for n in (
            "bf16_default_vs_f32_plain", "default_vs_stock"))
        reports.append(report)
        del model
    return {"component": "sinbevt_nuscenes_forward", "fault": fault,
            "budget": budget,
            "iou_floor": INT8_IOU_FLOOR,
            "centered_iou_floor": SINBEVT_CENTERED_IOU_FLOOR,
            "seeds": list(seeds),
            "ok": all(r["ok"] for r in reports),
            "max_rel": {n: max(r[n]["max_rel"] for r in reports)
                        for n in ("bf16_default_vs_f32_plain",
                                  "default_vs_stock")},
            "min_bev_iou": {n: min(r[n]["argmax_iou"]["bev"]
                                   for r in reports)
                            for n in ("bf16_default_vs_f32_plain",
                                      "default_vs_stock")},
            "min_centered_bev_iou": {n: min(r[n]["centered_bev_iou"]
                                            for r in reports)
                                     for n in ("bf16_default_vs_f32_plain",
                                               "default_vs_stock")},
            "per_seed": reports}


def validate_sinbevt_faults(device, seeds=(0,), config=None,
                            budget: float = BUDGET_SINBEVT) -> dict:
    """The SinBEVT gate once with each planted fault: what it reads, and
    whether it failed, as it must on each fault marked so."""
    faults = {}
    for name, (_, _, must_trip) in SINBEVT_FAULTS.items():
        r = validate_sinbevt(device, seeds, config, budget, fault=name)
        faults[name] = {"tripped": not r["ok"], "must_trip": must_trip,
                        "max_rel": r["max_rel"],
                        "min_bev_iou": r["min_bev_iou"],
                        "min_centered_bev_iou": r["min_centered_bev_iou"]}
    return {"seeds": list(seeds), "budget": budget, "faults": faults,
            "ok": all(f["tripped"] for f in faults.values()
                      if f["must_trip"])}


def loss_and_grads(model, criterion, batch, seed: int):
    """One train-mode forward and backward of ``model`` with every random
    draw seeded: (loss, {parameter: gradient in f64, zeros where the loss
    does not reach}).  The model's gradients are cleared before and after."""
    device = next(model.parameters()).device
    torch.manual_seed(seed)              # the modules' own dropouts
    gen = torch.Generator(device=device).manual_seed(seed)
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch, generator=gen)
    loss, _ = criterion(out, batch)
    loss.backward()
    grads = {name: (torch.zeros_like(p, dtype=torch.float64)
                    if p.grad is None else p.grad.double())
             for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def loss_and_grad_norms(model, criterion, batch, seed: int):
    """(loss, global gradient norm, {parameter: gradient norm}) of
    :func:`loss_and_grads`, norms taken in f64."""
    loss, grads = loss_and_grads(model, criterion, batch, seed)
    norms = {name: float(torch.linalg.vector_norm(g))
             for name, g in grads.items()}
    gnorm = float(np.sqrt(sum(v * v for v in norms.values())))
    return loss, gnorm, norms


def compare_train(flash, stock, control=None,
                  budget_scalar: float = BUDGET_SCALAR,
                  budget_layer: float = BUDGET_LAYER,
                  material_frac: float = MATERIAL_FRAC) -> dict:
    """The two-tier gate of the JAX ``validate_train``.  Parameters whose
    stock gradient norm is at least 0.1% of the global norm carry signal:
    such a layer fails when it is both relatively off by more than
    ``budget_layer`` and off by more than ``material_frac`` of the global
    norm.  The others are rounding noise around a gradient that is zero in
    exact arithmetic (a key-projection bias: softmax is invariant to it):
    their flash norm must stay within 3x the stock norm or 0.3% of the
    global norm."""
    loss_f, gnorm_f, norms_f = flash
    loss_s, gnorm_s, norms_s = stock
    loss_rel = abs(loss_f - loss_s) / (abs(loss_s) + 1e-9)
    gnorm_rel = abs(gnorm_f - gnorm_s) / (gnorm_s + 1e-9)
    floor = 1e-3 * gnorm_s
    layer_rels = {k: abs(norms_f[k] - norms_s[k]) / (norms_s[k] + 1e-12)
                  for k in norms_s if norms_s[k] >= floor}
    layer_bad = sorted(k for k, rel in layer_rels.items()
                       if rel > budget_layer and
                       abs(norms_f[k] - norms_s[k]) > material_frac * gnorm_s)
    noise = [k for k in norms_s if norms_s[k] < floor]
    noise_bad = sorted(k for k in noise
                       if norms_f[k] > max(3.0 * norms_s[k], 3.0 * floor))
    worst = max(layer_rels, key=layer_rels.get)
    material = max(abs(norms_f[k] - norms_s[k]) for k in norms_s) / gnorm_s
    finite = all(np.isfinite(v) for v in (loss_f, loss_s, gnorm_f, gnorm_s))
    ok = (finite and loss_rel <= budget_scalar and gnorm_rel <= budget_scalar
          and not layer_bad and not noise_bad)
    report = {
        "component": "train_step_flash_bwd", "ok": ok,
        "loss": {"flash": loss_f, "stock": loss_s, "rel": loss_rel},
        "grad_norm": {"flash": gnorm_f, "stock": gnorm_s, "rel": gnorm_rel},
        "layers_compared": len(layer_rels),
        "layer_failures": layer_bad[:5],
        "noise_tier_layers": len(noise),
        "noise_tier_failures": noise_bad[:5],
        "worst_layer": {"name": worst, "rel": layer_rels[worst],
                        "flash_norm": norms_f[worst],
                        "stock_norm": norms_s[worst]},
        "largest_layer_deviation_over_gnorm": material,
        # the worst relative drift among layers of at least 1% and 10% of
        # the global norm: what the per-layer budget is set from
        "worst_rel_of_layers_over": {
            f"{frac:g}": max((rel for k, rel in layer_rels.items()
                              if norms_s[k] >= frac * gnorm_s), default=0.0)
            for frac in (0.01, 0.1)},
        "budgets": {"scalar": budget_scalar, "per_layer": budget_layer,
                    "material_frac": material_frac, "signal_floor": floor},
    }
    if control is not None:
        loss_c, gnorm_c, _ = control
        report["bf16_cast_drift"] = {
            "note": "K5 path vs the composite backward with f32 epilogue "
                    "(COBEVT_FLASH_BWD_F32=1)",
            "loss_rel": abs(loss_f - loss_c) / (abs(loss_c) + 1e-9),
            "gnorm_rel": abs(gnorm_f - gnorm_c) / (gnorm_c + 1e-9)}
    return report


def validate_train(device, bf16: bool = True, seed: int = 0,
                   config=None, model_name: str = "corpbevt") -> dict:
    """Run the three backward paths on one model and return the gate's
    report, with the launch counts of the shipped path."""
    model, batch, _ = BUILD_MODEL[model_name](seed=seed, device=device,
                                              config=config)
    criterion, train_batch = make_criterion(model_name, model, batch)
    if bf16:
        model = model.to(torch.bfloat16)
    with env_switches(COBEVT_FLASH_BWD=None, COBEVT_FLASH_BWD_F32=None):
        ops.reset_launch_counts()
        flash = loss_and_grad_norms(model, criterion, train_batch, seed)
        counts = ops.launch_counts()
    with env_switches(COBEVT_FLASH_BWD=None, COBEVT_FLASH_BWD_F32="1"):
        control = loss_and_grad_norms(model, criterion, train_batch, seed)
    with env_switches(COBEVT_FLASH_BWD="0", COBEVT_FLASH_BWD_F32=None):
        stock = loss_and_grad_norms(model, criterion, train_batch, seed)
    report = compare_train(flash, stock, control, *TRAIN_BUDGETS[model_name])
    report["component"] = f"{model_name}_train_step_flash_bwd"
    report["precision"] = "bf16" if bf16 else "fp32"
    report["seed"] = seed
    report["launches"] = counts
    return report


def gradient_truth(device, seed: int = 0, config=None,
                   budget: float = BUDGET_TRUTH) -> dict:
    """The LiDAR step's gradients at a small width in bf16, on the shipped
    path and with ``COBEVT_FLASH_BWD=0``, each against the f32 plain path
    (every wrapper on its plain version, stock autograd): the relative L2
    distance over all gradients, ok while both stay within ``budget``."""
    cfg = config if config is not None else PointPillarConfig(**TRUTH_CONFIG)
    model, batch, _ = build_pointpillar(seed=seed, device=device, config=cfg)
    criterion, train_batch = make_criterion("pointpillar", model, batch)
    with env_switches(COBEVT_FLASH_BWD="0", COBEVT_FLASH_BWD_F32=None), \
            forced_impl("torch"):
        loss_t, truth = loss_and_grads(model, criterion, train_batch, seed)
    model = model.to(torch.bfloat16)
    norm_t = float(np.sqrt(sum(float((g * g).sum()) for g in truth.values())))
    report = {"component": "pointpillar_gradient_truth_f32",
              "loss_f32": loss_t, "grad_norm_f32": norm_t, "budget": budget,
              "seed": seed}
    for path, switch in (("flash", None), ("stock", "0")):
        with env_switches(COBEVT_FLASH_BWD=switch, COBEVT_FLASH_BWD_F32=None):
            loss, grads = loss_and_grads(model, criterion, train_batch, seed)
        dist = float(np.sqrt(sum(float(((grads[k] - truth[k]) ** 2).sum())
                                 for k in truth)))
        report[path] = {"loss_rel": abs(loss - loss_t) / (abs(loss_t) + 1e-9),
                        "grad_rel_l2": dist / (norm_t + 1e-30)}
    report["ok"] = all(np.isfinite(report[p]["grad_rel_l2"])
                       and report[p]["grad_rel_l2"] <= budget
                       for p in ("flash", "stock"))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true")
    p.add_argument("--model", default="corpbevt",
                   choices=["corpbevt", "pointpillar", "sinbevt"],
                   help="corpbevt: the int8 gate; pointpillar and sinbevt: "
                        "the model's forward gate (sinbevt at seeds 0-4); "
                        "with --train the model's gradient gate")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default; required unless this says cpu)")
    opt = p.parse_args(argv)
    if opt.device is None:
        if not torch.cuda.is_available():
            print("validate_kernels: no CUDA device; pass --device cpu to "
                  "run on the CPU", file=sys.stderr)
            return 1
        opt.device = "cuda"
    device, bf16 = torch.device(opt.device), opt.dtype == "bf16"
    if opt.train and opt.model == "sinbevt":
        print("validate_kernels: SinBEVT has no train step yet",
              file=sys.stderr)
        return 2
    if opt.model == "sinbevt":
        report = validate_sinbevt(device)
        report["planted"] = validate_sinbevt_faults(device)
        report["ok"] = report["ok"] and report["planted"]["ok"]
    elif opt.train:
        report = validate_train(device, bf16, opt.seed,
                                model_name=opt.model)
        if opt.model == "pointpillar":
            report["f32_truth"] = gradient_truth(device, opt.seed)
            report["ok"] = report["ok"] and report["f32_truth"]["ok"]
    elif opt.model == "corpbevt":
        report = validate_int8(device, bf16, opt.seed)
    else:
        report = validate_forward(device, bf16, opt.seed)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""On-card gates: the fused LiDAR forward against the stock one, and the
training backward (K1 + K5) against stock autograd.

**Forward gate** (``--model pointpillar``; the forward gate of
``cobevt_tpu/tools/validate_kernels.py`` for that model): the cooperative
LiDAR eval forward at full width, once on the shipped path (FuseBEVT as K6,
4 launches) and once with ``COBEVT_FUSED_FUSION=0`` (the stock modules, 4 K1
launches), same weights and batch; every output's largest deviation over the
stock output's largest value must stay within :data:`BUDGET_FORWARD`.

  python -m cobevt_tpu_torch.tools.validate_kernels --model pointpillar

**Gradient gate** (``--train``, CorpBEVT; ``validate_train`` of the JAX
tool): loss and gradients of one CorpBEVT train forward and
backward at ``corpbevt.yaml`` width in bf16, once on the shipped path (K1
forward, K5 flash backward) and once with ``COBEVT_FLASH_BWD=0`` (the plain
attention under stock autograd), same weights, batch and dropout seed.  It
compares the loss, the global gradient norm and every parameter's gradient
norm, and also prints the drift against the ``COBEVT_FLASH_BWD_F32=1``
control (the composite backward with f32 epilogue).

  python -m cobevt_tpu_torch.tools.validate_kernels --train

Needs a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.tools.benchmark import (
    build_corpbevt,
    build_pointpillar,
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


# Budget of the forward gate: max |fused - stock| over max |stock|, per
# output.  About 3x the drift measured on an NVIDIA H100 80GB HBM3 (700 W)
# at full LiDAR width in bf16 over seeds 0 and 1 and 5, 3, 1, 4, 2 live
# agents: K6 against the stock path 0.0075..0.0133 (one or two bf16 ulps of
# a logit near 2.4), the bf16 kernel path against the f32 plain path 0.0120
# and 0.0126.  The JAX package's 5% was set on a TPU.
BUDGET_FORWARD = 0.04


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def compare_outputs(name, fused, stock, budget: float) -> dict:
    """``compare`` of the JAX tool: per output the largest absolute
    deviation and its share of the stock output's largest value; ok when
    every share is within ``budget`` and everything is finite."""
    outputs = {}
    ok = True
    for key, s in stock.items():
        f, s = fused[key].float(), s.float()
        adiff = float((f - s).abs().max())
        rel = adiff / (float(s.abs().max()) + 1e-9)
        finite = bool(torch.isfinite(f).all() and torch.isfinite(s).all())
        ok = ok and finite and rel <= budget
        outputs[key] = {"abs": adiff, "rel": rel}
    return {"component": name, "ok": ok,
            "max_rel": max(o["rel"] for o in outputs.values()),
            "budget": budget, "outputs": outputs}


def validate_forward(device, bf16: bool = True, seed: int = 0,
                     config=None, max_cav: int = 5) -> dict:
    """Run the LiDAR eval forward on the fused and the stock FuseBEVT path
    and return the gate's report, with each path's launch counts."""
    model, batch, _ = build_pointpillar(max_cav, seed, device, config)
    model = model.eval()
    if bf16:
        model = model.to(torch.bfloat16)
    runs = {}
    for path, switch in (("fused", None), ("stock", "0")):
        with _env(COBEVT_FUSED_FUSION=switch), torch.no_grad():
            ops.reset_launch_counts()
            out = model(batch)
            runs[path] = (out, ops.launch_counts())
    report = compare_outputs("pointpillar_fused_vs_stock", runs["fused"][0],
                             runs["stock"][0], BUDGET_FORWARD)
    report["precision"] = "bf16" if bf16 else "fp32"
    report["seed"] = seed
    report["launches"] = {path: counts for path, (_, counts) in runs.items()}
    return report


def loss_and_grad_norms(model, criterion, batch, seed: int):
    """One train-mode forward and backward of ``model`` with every random
    draw seeded: (loss, global gradient norm, {parameter: gradient norm}),
    norms taken in f64.  The model's gradients are cleared before and
    after."""
    device = batch["inputs"].device
    torch.manual_seed(seed)              # the modules' own dropouts
    gen = torch.Generator(device=device).manual_seed(seed)
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch, generator=gen)
    loss, _ = criterion(out, batch)
    loss.backward()
    norms = {name: (0.0 if p.grad is None else
                    float(torch.linalg.vector_norm(p.grad.double())))
             for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    gnorm = float(np.sqrt(sum(v * v for v in norms.values())))
    return float(loss.detach()), gnorm, norms


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
        "component": "corpbevt_train_step_flash_bwd", "ok": ok,
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
                   config=None) -> dict:
    """Run the three backward paths on one model and return the gate's
    report, with the launch counts of the shipped path."""
    model, batch, _ = build_corpbevt(seed=seed, device=device, config=config)
    criterion, train_batch = make_criterion("corpbevt", model, batch)
    if bf16:
        model = model.to(torch.bfloat16)
    with _env(COBEVT_FLASH_BWD=None, COBEVT_FLASH_BWD_F32=None):
        ops.reset_launch_counts()
        flash = loss_and_grad_norms(model, criterion, train_batch, seed)
        counts = ops.launch_counts()
    with _env(COBEVT_FLASH_BWD=None, COBEVT_FLASH_BWD_F32="1"):
        control = loss_and_grad_norms(model, criterion, train_batch, seed)
    with _env(COBEVT_FLASH_BWD="0", COBEVT_FLASH_BWD_F32=None):
        stock = loss_and_grad_norms(model, criterion, train_batch, seed)
    report = compare_train(flash, stock, control)
    report["precision"] = "bf16" if bf16 else "fp32"
    report["launches"] = counts
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true")
    p.add_argument("--model", default="corpbevt",
                   choices=["corpbevt", "pointpillar"],
                   help="pointpillar: the forward gate; corpbevt with "
                        "--train: the gradient gate")
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
    if opt.train and opt.model == "pointpillar":
        print("validate_kernels: the LiDAR train step is not ported yet; "
              "--model pointpillar without --train runs the forward gate",
              file=sys.stderr)
        return 2
    if not opt.train and opt.model == "corpbevt":
        print("validate_kernels: CorpBEVT has --train (the gradient gate); "
              "its serving gates run in chip_smoke.py", file=sys.stderr)
        return 2
    if opt.train:
        report = validate_train(device, bf16, opt.seed)
    else:
        report = validate_forward(device, bf16, opt.seed)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

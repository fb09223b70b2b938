#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cobevt_tpu_torch) on one GPU.

  python3 chip_smoke.py [--out results.json]

Phases, all under main(); any failure raises and the process exits
non-zero without printing the final line:

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: compiles K1 and K8 (csrc/window_attention.cu), K2
     (csrc/fused_cross_attention.cu), K3 (csrc/conv3x3.cu), K4
     (csrc/fused_swap_fusion.cu) and K5 (csrc/window_attention_bwd.cu) with
     nvcc for sm_90a from the checkout's sources, one nvcc process each, all
     started together;
  3. kernels vs plain: every kernel against its plain PyTorch version on
     the card at every shape of the CorpBEVT serving forward and train step
     (5 agents x 4 cameras x 512^2, BEV 256^2), in f32 and bf16, timed with
     CUDA events, each beside its bound (the larger of its bytes over 3.35
     TB/s and its operations over 989 TFLOP/s) and, where one PyTorch call
     computes the same function, that call's time;
  4. slice, the serving default (COBEVT_FUSED_XATTN and
     COBEVT_FUSED_FUSION unset): full-width CorpBEVT (ResNet-34, seeded
     random weights) in bf16 serves synthetic requests with mixed
     live-agent counts through the staged runner; the launch counters show
     every frame ran 1 K1, 6 x 4 K2, 20 K3 and 19 K4 launches; one frame is
     checked against the plain path in f32 (argmax IoU >= 0.99 on
     dynamic_seg);
  5. stock path (both switches "0"): a shorter run with 13 K1 and 20 K3
     launches per frame, and the argmax IoU of its bf16 output against the
     fused path's on one frame;
  6. train: a few optimizer steps of full-width CorpBEVT in bf16 (f32
     master parameters) on the seeded synthetic batch, through the code of
     cobevt_tpu_torch/tools/benchmark.py: every step runs 13 K1 and 12 K5
     launches and none of K2, K3, K4, with finite loss and gradient norm;
     then the gradient gate of tools/validate_kernels.py (K1 + K5 against
     COBEVT_FLASH_BWD=0, same dropout seed);
  7. K8: the head-major entry point, forward and gradients, at the
     self-attention and the fusion shape.

The last stdout lines are the kernels JSON line, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

# per-frame shapes of the CorpBEVT serving forward at 5 live agents
# (name, G, Tq, Tk, bias, mask, weight, launches per frame on the stock
# path, on the fused path); H=4, D=32
K1_CASES = [
    ("fax_local_stage0", 320, 1024, 256, False, False, False, 1, 0),
    ("fax_grid_stage0", 320, 256, 256, False, False, False, 1, 0),
    ("fax_stage1", 80, 256, 256, False, False, False, 2, 0),
    ("fax_stage2", 5, 1024, 1024, False, False, False, 2, 0),
    ("fax_self_attn", 5, 1024, 1024, True, False, False, 1, 1),
    ("fusion", 16, 320, 320, True, True, False, 6, 0),
    # off the serving path: the other operand combinations
    ("fusion_mask_only", 16, 320, 320, False, True, False, 0, 0),
    ("fusion_weight_only", 16, 320, 320, False, False, True, 0, 0),
    ("self_attn_dropout", 5, 1024, 1024, True, False, True, 0, 0),
    ("fusion_fully_masked_window", 16, 320, 320, True, True, False, 0, 0),
]
K1_HEADS, K1_HEAD_DIM = 4, 32
# K5: the backward of every weight-free K1 call of a train step (name, G,
# Tq, Tk, bias, mask, calls per step); the 13th attention of a step, the
# self-attention with its dropout weight, takes the composite backward
K5_CASES = [
    ("fax_local_stage0", 320, 1024, 256, False, False, 1),
    ("fax_grid_stage0", 320, 256, 256, False, False, 1),
    ("fax_stage1", 80, 256, 256, False, False, 2),
    ("fax_stage2", 5, 1024, 1024, False, False, 2),
    ("fusion", 16, 320, 320, True, True, 6),
    # off the train step: dropout-free self-attention and the other operand
    # combinations
    ("fax_self_attn_no_dropout", 5, 1024, 1024, True, False, 0),
    ("fusion_bias_only", 16, 320, 320, True, False, 0),
    ("fusion_mask_only", 16, 320, 320, False, True, 0),
    ("fusion_fully_masked_window", 16, 320, 320, True, True, 0),
]
# K8: head-major attention (name, G, Tq, Tk, bias, mask)
K8_CASES = [
    ("fax_self_attn", 5, 1024, 1024, True, False),
    ("fax_local_stage0", 320, 1024, 256, False, False),
    ("fusion", 16, 320, 320, True, True),
]
# (name, N, H, W, C=O, residual, launches per frame); N = 5 agents x 4 cams
K3_CASES = [
    ("layer2", 20, 64, 64, 128, False, 3),
    ("layer2_residual", 20, 64, 64, 128, True, 3),
    ("layer3", 20, 32, 32, 256, False, 5),
    ("layer3_residual", 20, 32, 32, 256, True, 5),
    ("layer4", 20, 16, 16, 512, False, 2),
    ("layer4_residual", 20, 16, 16, 512, True, 2),
]
# K2: the six FAX cross-view branches of a 5-agent frame (B = 5 agents,
# n = 4 cameras, D = C = 128, 4 heads); each is one call of 4 launches
# (name, BEV H=W, keys h=w, q_win, k_win, embed, post_ln, grid keys)
K2_CASES = [
    ("stage0_local", 128, 64, 16, 8, True, False, False),
    ("stage0_grid", 128, 64, 16, 8, False, True, True),
    ("stage1_local", 64, 32, 16, 8, False, False, False),
    ("stage1_grid", 64, 32, 16, 8, False, True, True),
    ("stage2_local", 32, 16, 32, 16, False, False, False),
    ("stage2_grid", 32, 16, 32, 16, False, True, True),
]
K2_B, K2_CAMS, K2_DIM, K2_HEADS = 5, 4, 128, 4
# K4: the FuseBEVT encoder at CorpBEVT (B 1, L 5 = max_cav, 32^2, D 128,
# window 8, 4 heads, depth 3, mlp 256); (name, mask, mean_over_valid,
# calls per frame)
K4_CASES = [
    ("encoder_masked", True, False, 1),
    ("encoder_mean_over_valid", True, True, 0),
    ("encoder_unmasked", False, False, 0),
]
# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain|.
# f32: sums in another order (and __expf in K1).  bf16: both round an f32
# result to bf16 once, so they differ by about one bf16 ulp (2^-8 rel).
# K4 in bf16 rounds its residual state after each of 6 sublayers, and a
# one-ulp flip at |x| ~ 4 (0.03) carries on: 5e-2 abs.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
K4_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}
# K5: dq, dk, dv and dbias are sums of up to 1024 terms, so the tolerance is
# a share of the plain result's largest value: f32 1e-4 (sums in another
# order; dbias also sums the windows with atomics, in any order), bf16 2e-2
# (the kernel takes the row maximum per head, the plain version over all
# heads as the TPU body does, so the exp rounds to bf16 elsewhere: one bf16
# ulp on a weight, summed with random signs).
K5_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the card's published peaks (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TRAIN_STEPS = 3
TRAIN_PER_STEP = {"fused_window_attention_packed": 13,
                  "fused_window_attention_packed_bwd": 12,
                  "fused_cross_view_attention": 0, "fused_conv3x3": 0,
                  "fused_swap_fusion": 0, "fused_window_attention": 0}
SERVE_AGENTS = [5, 3, 1, 4, 2, 5, 3, 5, 2, 4]
STOCK_AGENTS = [5, 2, 4]
# launches per frame on each path: K2 6 branches x 4, K4 3 blocks x 2
# sublayers x 3 + the head (ops/fused_*.py: LAUNCHES_PER_CALL,
# launches_per_call)
FUSED_PER_FRAME = {"fused_window_attention_packed": 1,
                   "fused_cross_view_attention": 6 * 4,
                   "fused_conv3x3": 20, "fused_swap_fusion": 3 * 2 * 3 + 1}
STOCK_PER_FRAME = {"fused_window_attention_packed": 13,
                   "fused_cross_view_attention": 0,
                   "fused_conv3x3": 20, "fused_swap_fusion": 0}
KERNELS = ("window_attention", "fused_cross_attention", "conv3x3",
           "fused_swap_fusion", "window_attention_bwd")
IOU_FLOOR = 0.99


def log(msg=""):
    print(msg, flush=True)


def run(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {out.stderr.strip()}")
    return out.stdout.strip()


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def compare(got, want, dtype_name, tol=TOL):
    import torch
    atol, rtol = tol[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    diff = (g - w).abs()
    abs_err = float(diff.max())
    rel_err = abs_err / (float(w.abs().max()) + 1e-12)
    worst = float((diff - (atol + rtol * w.abs())).max())
    return abs_err, rel_err, worst <= 0


def compare_scaled(got, want, dtype_name):
    """|kernel - plain| <= tol * (max|plain| + |plain|): K5's check."""
    import torch
    tol = K5_TOL[dtype_name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output has non-finite values")
    scale = max(float(w.abs().max()), 1e-3)
    diff = (g - w).abs()
    abs_err = float(diff.max())
    worst = float((diff - tol * (scale + w.abs())).max())
    return abs_err, abs_err / scale, worst <= 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops, bytes_, dtype_name):
    """The least time (ms) the card could take: the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def argmax_iou(a, b):
    """Mean over classes of the IoU between two argmax maps (the check of
    cobevt_tpu/tools/validate_kernels.py:argmax_iou)."""
    import numpy as np
    a, b = a.argmax(-1), b.argmax(-1)
    ious = []
    for c in np.union1d(np.unique(a), np.unique(b)):
        union = np.logical_or(a == c, b == c).sum()
        if union:
            ious.append(np.logical_and(a == c, b == c).sum() / union)
    return float(np.mean(ious)) if ious else 1.0


def phase_environment():
    import torch
    log("== environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from cobevt_tpu_torch.ops import _build
    nvcc = _build.nvcc()
    log(f"nvcc {nvcc}: {run([nvcc, '--version']).splitlines()[-1]}")
    log(f"triton importable: {importlib.util.find_spec('triton') is not None}"
        f"  ninja on PATH: {shutil.which('ninja') is not None}")
    log(f"card: {card_line()}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from cobevt_tpu_torch.ops import _build
    log("== build")
    t0 = time.perf_counter()
    builds = _build.build_all(KERNELS)
    log(f"{len(builds)} kernels built in {time.perf_counter() - t0:.1f} s")
    for name, b in builds.items():
        log(f"{name}: {b.seconds:.1f} s -> {b.path}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
        _build.load(name)


def k1_inputs(case, dtype, gen):
    import torch
    name, G, Tq, Tk, has_bias, has_mask, has_weight = case[:7]
    C = K1_HEADS * K1_HEAD_DIM
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = (randn(G, Tq, C) * K1_HEAD_DIM ** -0.5).to(dtype)
    k, v = randn(G, Tk, C).to(dtype), randn(G, Tk, C).to(dtype)
    bias = randn(Tq, K1_HEADS * Tk) * 0.5 if has_bias else None
    mask = None
    if has_mask:
        mask = (torch.rand(G, Tk, generator=gen, device=dev) > 0.3).float()
        if name == "fusion_fully_masked_window":
            mask[3] = 0.0
    weight = None
    if has_weight:
        keep = torch.rand(G, Tq, K1_HEADS * Tk, generator=gen, device=dev)
        weight = ((keep > 0.1).float() / 0.9).to(dtype)
    return q, k, v, bias, mask, weight


def k3_inputs(case, dtype, gen):
    import torch
    _, N, H, W, C, residual, _ = case
    dev = "cuda"
    x = torch.randn(N, H, W, C, generator=gen, device=dev).relu().to(dtype)
    w = torch.randn(3, 3, C, C, generator=gen, device=dev)
    w = w * (2 / (9 * C)) ** 0.5
    shift = torch.randn(C, generator=gen, device=dev) * 0.1
    res = None
    if residual:
        res = torch.randn(N, H, W, C, generator=gen, device=dev).relu().to(
            dtype)
    return x, w, shift, res


def _ln_pair(randn, D):
    return 1.0 + 0.1 * randn(D), 0.1 * randn(D)


def k2_inputs(case, dtype, gen):
    """x, w_embed, c_embed, key, val, params, mlp, post_ln of one FAX
    branch at its serving shape, weights scaled like the seeded model's."""
    import torch
    _, H, h, _, _, embed, post, _ = case
    B, n, D = K2_B, K2_CAMS, K2_DIM

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(B, H, H, D).to(dtype)
    key, val = randn(B, n, h, h, D).to(dtype), randn(B, n, h, h, D).to(dtype)
    w_embed = randn(H, H, D).to(dtype) if embed else None
    c_embed = randn(B, n, D).to(dtype) if embed else None
    params = {f"ln_{t}": _ln_pair(randn, D) for t in "qkv"}
    for t in "qkvo":
        params[f"w{t}"] = randn(D, D, scale=D ** -0.5)
        params[f"b{t}"] = randn(D, scale=0.02)
    mlp = {"ln": _ln_pair(randn, D), "w1": randn(D, 2 * D, scale=D ** -0.5),
           "b1": randn(2 * D, scale=0.02),
           "w2": randn(2 * D, D, scale=(2 * D) ** -0.5),
           "b2": randn(D, scale=0.02)}
    post_ln = _ln_pair(randn, D) if post else None
    return x, w_embed, c_embed, key, val, params, mlp, post_ln


def k4_inputs(case, dtype, gen):
    """x, mask, agent_mask, bias_stack, layers, head of the FuseBEVT
    encoder at CorpBEVT (one frame, 3 live agents of max_cav 5)."""
    import torch
    _, masked, _, _ = case
    B, L, H, D, w, heads, depth, mlp = 1, 5, 32, 128, 8, 4, 3, 256
    T = L * w * w

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def sub():
        return {"ln_a": _ln_pair(randn, D),
                "wqkv": randn(D, 3 * D, scale=D ** -0.5),
                "wout": randn(D, D, scale=D ** -0.5),
                "ln_f": _ln_pair(randn, D),
                "w1": randn(D, mlp, scale=D ** -0.5),
                "b1": randn(mlp, scale=0.02),
                "w2": randn(mlp, D, scale=mlp ** -0.5),
                "b2": randn(D, scale=0.02)}

    agent_mask = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0]], device="cuda")
    mask = None
    if masked:
        mask = (torch.rand(B, L, H, H, generator=gen, device="cuda")
                > 0.3).float() * agent_mask[:, :, None, None]
        mask[:, 0] = 1.0
    layers = [(sub(), sub()) for _ in range(depth)]
    bias = randn(depth, 2, T, heads * T, scale=0.02)
    head = {"ln": _ln_pair(randn, D), "w": randn(D, D, scale=D ** -0.5),
            "b": randn(D, scale=0.02)}
    return (randn(B, L, H, H, D).to(dtype), mask, agent_mask, bias, layers,
            head, w, heads)


def sdpa_mask(bias_flat, mask, dtype):
    """Packed bias (Tq, H*Tk) and key mask (G, Tk) as the additive
    ``attn_mask`` of ``scaled_dot_product_attention``, or None."""
    import torch
    add = None
    if bias_flat is not None:
        Tq = bias_flat.shape[0]
        add = bias_flat.reshape(Tq, K1_HEADS, -1).permute(1, 0, 2)[None]
        add = add.to(dtype)
    if mask is not None:
        m = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :].to(dtype)
        add = m if add is None else add + m
    if add is not None:
        add = add.contiguous()
    return add


def attention_work(G, Tq, Tk, products):
    """Operations of ``products`` (Tq x Tk x D) products per (window, head):
    2 for a forward, 5 for the backward."""
    return 2.0 * products * G * K1_HEADS * Tq * Tk * K1_HEAD_DIM


def k2_work(case, dtype_size):
    """(operations, bytes) of one FAX cross-view branch."""
    _, H, h, q_win, k_win, embed, _, _ = case
    B, n, D = K2_B, K2_CAMS, K2_DIM
    nq = n if embed else 1
    rows_k, rows_q, rows_o = B * n * h * h, B * nq * H * H, B * H * H
    windows = B * (H // q_win) ** 2
    flops = 2.0 * D * D * (2 * rows_k + rows_q + rows_o + 4 * rows_o)
    flops += 4.0 * windows * nq * q_win ** 2 * n * k_win ** 2 * D
    elems = 2 * rows_k * D + 2 * rows_o * D + 8 * D * D
    if embed:
        elems += H * H * D + B * n * D
    return flops, elems * dtype_size


def k4_work(dtype_size):
    """(operations, bytes) of the FuseBEVT encoder at CorpBEVT."""
    B, L, H, D, w, depth, mlp = 1, 5, 32, 128, 8, 3, 256
    rows, T, G = B * L * H * H, L * w * w, B * (H // w) ** 2
    sub = 2.0 * rows * D * (3 * D + D + 2 * mlp) + 4.0 * G * T * T * D
    flops = 2 * depth * sub + 2.0 * B * H * H * D * D
    weights = 2 * depth * (4 * D * D + 2 * D * mlp) + D * D
    elems = rows * D + B * H * H * D + weights + 2 * depth * T * 4 * T
    return flops, elems * dtype_size + B * L * H * H * 4


def phase_kernels():
    """Every kernel vs its plain version at every slice shape, f32 and
    bf16.  Returns one row per (case, dtype); raises if any disagrees."""
    import torch
    import torch.nn.functional as F
    from cobevt_tpu_torch.ops.conv2d import fused_conv3x3
    from cobevt_tpu_torch.ops.fused_cross_attention import (
        fused_cross_view_attention,
        pack_params,
    )
    from cobevt_tpu_torch.ops.fused_swap_fusion import fused_swap_fusion, pack
    from cobevt_tpu_torch.ops.window_attention import (
        _packed_to_4d,
        fused_window_attention,
        fused_window_attention_packed,
        fused_window_attention_packed_bwd,
    )
    log("== kernels vs plain versions (CUDA events, after warmup)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    details = []
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case in K1_CASES:
            q, k, v, bias, mask, weight = k1_inputs(case, dtype, gen)

            def attn(impl):
                return fused_window_attention_packed(
                    q, k, v, K1_HEADS, bias_flat=bias, mask=mask,
                    weight=weight, impl=impl)

            got, want = attn("kernel"), attn("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            iters = 3 if case[1] * case[2] * case[3] > 5e7 else 10
            row = {"kernel": "K1", "case": case[0], "dtype": dname,
                   "per_frame": case[8], "per_frame_stock": case[7],
                   "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: attn("kernel"), iters),
                   "plain_ms": time_ms(lambda: attn("torch"), iters)}
            row.update(bound(attention_work(*case[1:4], 2),
                             nbytes(q, k, v, got, bias, mask, weight), dname))
            if weight is None:
                # one library call expresses bias and mask as an additive
                # mask; the dropout weight it cannot take
                q4, k4, v4 = (_packed_to_4d(t, K1_HEADS) for t in (q, k, v))
                add = sdpa_mask(bias, mask, dtype)
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=add, scale=1.0), iters)
                del q4, k4, v4, add
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, bias, mask, weight, got, want
        for case in K3_CASES:
            x, w, shift, res = k3_inputs(case, dtype, gen)

            def conv(impl):
                return fused_conv3x3(x, w, shift, res, relu=True, impl=impl)

            got, want = conv("kernel"), conv("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_cl = x.permute(0, 3, 1, 2)
            row = {"kernel": "K3", "case": case[0], "dtype": dname,
                   "per_frame": case[6], "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: conv("kernel"), 5),
                   "plain_ms": time_ms(lambda: conv("torch"), 5),
                   "library_ms": time_ms(
                       lambda: F.conv2d(x_cl, w_oihw, padding=1), 5)}
            _, N, H, W, C = case[:5]
            row.update(bound(2.0 * N * H * W * 9 * C * C,
                             nbytes(x, w, shift, res, got), dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del x, w, shift, res, got, want
        for case in K2_CASES:
            x, we, ce, key, val, params, mlp, post_ln = k2_inputs(
                case, dtype, gen)
            _, _, _, q_win, k_win, _, _, grid = case
            # packed once, as the model packs its weights once
            packed = pack_params(params, mlp, post_ln, dtype)

            def xattn(impl):
                return fused_cross_view_attention(
                    x, we, ce, key, val, packed, (q_win, q_win),
                    (k_win, k_win), K2_HEADS, (K2_DIM // K2_HEADS) ** -0.5,
                    add_skip=True, impl=impl, grid_keys=grid)

            got, want = xattn("kernel"), xattn("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            row = {"kernel": "K2", "case": case[0], "dtype": dname,
                   "per_frame": 1, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: xattn("kernel"), 5),
                   "plain_ms": time_ms(lambda: xattn("torch"), 5)}
            row.update(bound(*k2_work(case, x.element_size()), dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del x, we, ce, key, val, params, mlp, post_ln, packed, got, want
        for case in K4_CASES:
            x, mask, am, bias, layers, head, w, heads = k4_inputs(
                case, dtype, gen)
            packed = pack(layers, bias, head, dtype)

            def fusion(impl):
                return fused_swap_fusion(x, mask, am, None, packed, None, w,
                                         heads, mean_over_valid=case[2],
                                         impl=impl)

            got, want = fusion("kernel"), fusion("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname, K4_TOL)
            row = {"kernel": "K4", "case": case[0], "dtype": dname,
                   "per_frame": case[3], "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: fusion("kernel"), 10),
                   "plain_ms": time_ms(lambda: fusion("torch"), 10)}
            row.update(bound(*k4_work(x.element_size()), dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del x, mask, am, bias, layers, head, packed, got, want
        for case in K5_CASES:
            name, G, Tq, Tk, has_bias, has_mask, per_step = case
            q, k, v, bias, mask, _ = k1_inputs(
                (name, G, Tq, Tk, has_bias, has_mask, False), dtype, gen)
            g = torch.randn(G, Tq, K1_HEADS * K1_HEAD_DIM, generator=gen,
                            device="cuda").to(dtype)
            out = fused_window_attention_packed(q, k, v, K1_HEADS, bias, mask,
                                                impl="kernel")

            def bwd(impl):
                return fused_window_attention_packed_bwd(
                    q, k, v, g, out, K1_HEADS, bias, mask, impl=impl)

            got, want = bwd("kernel"), bwd("torch")
            torch.cuda.synchronize()
            errs = {}
            ok = True
            for part, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
                if (a is None) != (b is None) or (a is None) != (
                        part == "dbias" and bias is None):
                    raise AssertionError(f"K5 {name}: {part} presence")
                if a is not None:
                    abs_err, rel_err, part_ok = compare_scaled(a, b, dname)
                    errs[part] = (abs_err, rel_err)
                    ok = ok and part_ok
            iters = 3 if G * Tq * Tk > 5e7 else 10
            row = {"kernel": "K5", "case": name, "dtype": dname,
                   "per_frame": per_step,
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "max_rel_err": max(e[1] for e in errs.values()),
                   "errors": {k_: list(e) for k_, e in errs.items()},
                   "ok": ok, "ms": time_ms(lambda: bwd("kernel"), iters)}
            del want
            row["plain_ms"] = time_ms(lambda: bwd("torch"), 2, warmup=1)
            row.update(bound(
                attention_work(G, Tq, Tk, 5),
                nbytes(q, k, v, g, out, bias, mask, *got), dname))
            # library yardstick: forward + backward of one
            # scaled_dot_product_attention call, less its forward
            leaves = [_packed_to_4d(t, K1_HEADS).contiguous().requires_grad_()
                      for t in (q, k, v)]
            add = sdpa_mask(bias, mask, dtype)
            if add is not None and bias is not None:
                add = add.requires_grad_()
            g4 = _packed_to_4d(g, K1_HEADS).contiguous()

            def sdpa(backward):
                o = F.scaled_dot_product_attention(*leaves, attn_mask=add,
                                                   scale=1.0)
                if backward:
                    o.backward(g4)

            row["library_ms"] = max(
                time_ms(lambda: sdpa(True), iters)
                - time_ms(lambda: sdpa(False), iters), 0.0)
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, g, out, bias, mask, got, leaves, add, g4
        for case in K8_CASES:
            name, G, Tq, Tk, has_bias, has_mask = case
            q, k, v, bias, mask, _ = k1_inputs(
                (name, G, Tq, Tk, has_bias, has_mask, False), dtype, gen)
            q, k, v = (_packed_to_4d(t, K1_HEADS).contiguous()
                       for t in (q, k, v))
            if bias is not None:
                bias = bias.reshape(Tq, K1_HEADS, Tk).permute(
                    1, 0, 2).contiguous()

            def hm(impl):
                return fused_window_attention(q, k, v, bias, mask, impl=impl)

            got, want = hm("kernel"), hm("torch")
            torch.cuda.synchronize()
            abs_err, rel_err, ok = compare(got, want, dname)
            iters = 3 if G * Tq * Tk > 5e7 else 10
            add = sdpa_mask(None, mask, dtype)
            if bias is not None:
                add = bias[None].to(dtype) if add is None else \
                    add + bias[None].to(dtype)
            row = {"kernel": "K8", "case": name, "dtype": dname,
                   "per_frame": 1, "max_abs_err": abs_err,
                   "max_rel_err": rel_err, "ok": ok,
                   "ms": time_ms(lambda: hm("kernel"), iters),
                   "plain_ms": time_ms(lambda: hm("torch"), iters),
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=add, scale=1.0), iters)}
            row.update(bound(attention_work(G, Tq, Tk, 2),
                             nbytes(q, k, v, got, bias, mask), dname))
            details.append(row)
            if not ok:
                failures.append(row)
            del q, k, v, bias, mask, got, want, add
    for r in details:
        extra = f"  library={r['library_ms']:.3f} ms" \
            if r.get("library_ms") is not None else ""
        log(f"{r['kernel']} {r['case']:<28} {r['dtype']:<8} "
            f"abs={r['max_abs_err']:.2e} rel={r['max_rel_err']:.2e} "
            f"{'ok ' if r['ok'] else 'BAD'} kernel={r['ms']:.3f} ms "
            f"plain={r['plain_ms']:.3f} ms bound={r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){extra}")
    if failures:
        raise AssertionError(f"{len(failures)} kernel cases disagree with "
                             f"their plain versions: "
                             f"{[(r['case'], r['dtype']) for r in failures]}")
    return details


SWITCHES = ("COBEVT_FUSED_XATTN", "COBEVT_FUSED_FUSION")


@contextlib.contextmanager
def switches(value):
    """Both fusion switches unset (None: the serving default) or set to
    ``value`` inside the block."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if value is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = value
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serve_path(name, runner, frames, cfg, rng, per_frame, check):
    """Serve ``frames`` with every launch count set to 0 just before and
    read just after; raise unless each kernel ran ``per_frame`` launches
    in every frame (bucket warmups included)."""
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import serve_camera
    calls = []

    def counted(batch):
        calls.append(1)
        return runner(batch)

    ops.reset_launch_counts()
    summary = serve_camera.serve(counted, frames, cfg, rng, on_output=check)
    counts = ops.launch_counts()
    log(f"{name}: served {summary['frames']} requests ({len(calls)} frames "
        f"with the bucket warmups); launches {counts}, per frame "
        f"{ {k: c / len(calls) for k, c in counts.items()} }")
    for i, (ms, (n, _)) in enumerate(zip(summary["frame_ms"], frames)):
        log(f"  request {i}: {n} agents, {ms:.2f} ms")
    log(f"{name} summary " + json.dumps(
        {k: v for k, v in summary.items() if k != "frame_ms"}))
    for fn, n in per_frame.items():
        if counts[fn] != n * len(calls):
            raise AssertionError(f"{name}: {fn} ran {counts[fn]} launches "
                                 f"over {len(calls)} frames, expected {n} "
                                 f"each")
    return counts, summary


def phase_slice(seed=0):
    """Full-width CorpBEVT serving on the fused path (the default), one
    frame against the f32 plain path, then the stock path."""
    import numpy as np
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.configs.presets import corpbevt_default
    from cobevt_tpu_torch.models.corpbevt import CorpBEVT
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.utils.serving import StagedBucketedRunner
    from cobevt_tpu_torch.utils.weights import seeded_init_

    log("== slice: CorpBEVT 5 agents x 4 cameras x 512^2, BEV 256^2, bf16, "
        "fused path (switches unset)")
    cfg = corpbevt_default()
    model = CorpBEVT(cfg)
    seeded_init_(model, seed)
    model = model.to("cuda", torch.bfloat16).eval()
    rng = np.random.RandomState(seed)
    frames = [(n, serve_camera.synthetic_frame(rng, cfg, n))
              for n in SERVE_AGENTS]
    runner = StagedBucketedRunner(model, cfg.max_cav)

    def check(i, n, out):
        seg = out["dynamic_seg"]
        if tuple(seg.shape) != (1, 1, 256, 256, cfg.output_class):
            raise AssertionError(f"frame {i}: dynamic_seg {tuple(seg.shape)}")
        if not torch.isfinite(seg).all():
            raise AssertionError(f"frame {i} ({n} agents): non-finite logits")

    frame = frames[0][1]
    with switches(None):
        counts, summary = serve_path("fused path", runner, frames, cfg, rng,
                                     FUSED_PER_FRAME, check)
        # A/B context: the same requests through the plain versions, bf16
        with ops.forced_impl("torch"):
            plain = serve_camera.serve(runner, frames, cfg, rng,
                                       on_output=check)
        log("plain-version summary " + json.dumps(
            {k: v for k, v in plain.items() if k != "frame_ms"}))
        # reference: one 5-agent frame, plain versions, f32, same weights
        out = runner(frame)["dynamic_seg"].float().cpu().numpy()
        ref_model = copy.deepcopy(model).float()
        with ops.forced_impl("torch"):
            ref = StagedBucketedRunner(ref_model, cfg.max_cav)(frame)
        ref = ref["dynamic_seg"].cpu().numpy()
        del ref_model
    iou = argmax_iou(out, ref)
    agree = float((out.argmax(-1) == ref.argmax(-1)).mean())
    rel = float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-12))
    frac = np.bincount(ref.argmax(-1).ravel(),
                       minlength=cfg.output_class) / ref[..., 0].size
    log(f"bf16 kernels vs f32 plain, one 5-agent frame: argmax IoU {iou:.5f}"
        f", agreement {agree:.5f}, max rel logit err {rel:.3e}, "
        f"reference class shares {np.round(frac, 4).tolist()}")
    if iou < IOU_FLOOR:
        raise AssertionError(f"argmax IoU {iou:.4f} < {IOU_FLOOR}")

    log("== stock path: COBEVT_FUSED_XATTN=0 COBEVT_FUSED_FUSION=0, bf16")
    with switches("0"):
        stock_counts, stock = serve_path(
            "stock path", runner, [frames[SERVE_AGENTS.index(n)]
                                   for n in STOCK_AGENTS],
            cfg, rng, STOCK_PER_FRAME, check)
        stock_out = runner(frame)["dynamic_seg"].float().cpu().numpy()
    stock_iou = argmax_iou(out, stock_out)
    log(f"fused vs stock path, bf16, one 5-agent frame: argmax IoU "
        f"{stock_iou:.5f}")
    if stock_iou < IOU_FLOOR:
        raise AssertionError(f"fused vs stock argmax IoU {stock_iou:.4f} < "
                             f"{IOU_FLOOR}")
    return counts, summary, plain, {
        "argmax_iou": iou, "agreement": agree, "max_rel_logit_err": rel,
        "fused_vs_stock_argmax_iou": stock_iou,
        "stock_counts": stock_counts, "stock_serve": stock}


def phase_train(seed=0):
    """A few optimizer steps at corpbevt.yaml width in bf16 through the
    code of tools/benchmark.py, with exact launch counts per step, then the
    K1 + K5 against stock-autograd gradient gate."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.tools import benchmark, validate_kernels

    log("== train: CorpBEVT 5 agents x 4 cameras x 512^2, BEV 256^2, bf16 "
        "compute, f32 master parameters, B 1")
    opt = benchmark.parse_args(["--train", "--iters", str(TRAIN_STEPS),
                                "--warmup", "1", "--seed", str(seed)])
    device = torch.device("cuda", torch.cuda.current_device())
    model, batch, _ = benchmark.build_corpbevt(opt.max_cav, opt.seed, device)
    ops.reset_launch_counts()
    row = benchmark.measure_train(model, opt.model, batch, opt, device)
    counts = ops.launch_counts()
    log("train " + json.dumps(row))
    log(f"train launches over {TRAIN_STEPS} steps after one warmup step: "
        f"{counts}")
    for fn, n in TRAIN_PER_STEP.items():
        if counts[fn] != n * TRAIN_STEPS:
            raise AssertionError(f"train: {fn} ran {counts[fn]} launches over "
                                 f"{TRAIN_STEPS} steps, expected {n} each")
    import math
    if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
        raise AssertionError(f"train: loss {row['loss']}, gradient norm "
                             f"{row['grad_norm']}")
    del model, batch
    torch.cuda.empty_cache()

    log("== gradient gate: K1 + K5 vs COBEVT_FLASH_BWD=0, one step, bf16")
    gate = validate_kernels.validate_train(device, bf16=True, seed=seed)
    log("gate " + json.dumps(gate))
    for fn in ("fused_window_attention_packed",
               "fused_window_attention_packed_bwd"):
        if gate["launches"][fn] != TRAIN_PER_STEP[fn]:
            raise AssertionError(f"gate: {fn} ran {gate['launches'][fn]}")
    if not gate["ok"]:
        raise AssertionError("gradient gate failed: " + json.dumps(gate))
    torch.cuda.empty_cache()
    return counts, row, gate


def phase_k8(seed=0):
    """The head-major entry point as a caller uses it: forward and
    gradients through autograd at the self-attention and the fusion shape,
    against the plain version.  Returns the launch count."""
    import torch
    from cobevt_tpu_torch import ops
    from cobevt_tpu_torch.ops.window_attention import fused_window_attention

    log("== K8: fused_window_attention forward + gradients, bf16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = torch.bfloat16
    ops.reset_launch_counts()
    for name, G, Tq, Tk, has_bias, has_mask in K8_CASES[::2]:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        q = (randn(G, K1_HEADS, Tq, K1_HEAD_DIM) * K1_HEAD_DIM ** -0.5).to(
            dtype)
        k = randn(G, K1_HEADS, Tk, K1_HEAD_DIM).to(dtype)
        v = randn(G, K1_HEADS, Tk, K1_HEAD_DIM).to(dtype)
        bias = randn(K1_HEADS, Tq, Tk) * 0.5 if has_bias else None
        mask = ((torch.rand(G, Tk, generator=gen, device="cuda") > 0.3)
                .float() if has_mask else None)
        g = randn(G, K1_HEADS, Tq, K1_HEAD_DIM).to(dtype)
        results = {}
        for impl in ("kernel", "torch"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            b = None if bias is None else bias.clone().requires_grad_()
            out = fused_window_attention(*leaves, b, mask, impl=impl)
            out.backward(g)
            results[impl] = [out.detach()] + [t.grad for t in leaves] + (
                [] if b is None else [b.grad])
        torch.cuda.synchronize()
        for part, a, w in zip(("out", "dq", "dk", "dv", "dbias"),
                              results["kernel"], results["torch"]):
            abs_err, rel_err, ok = compare_scaled(a, w, "bfloat16")
            log(f"K8 {name} {part}: abs={abs_err:.2e} rel={rel_err:.2e} "
                f"{'ok' if ok else 'BAD'}")
            if not ok:
                raise AssertionError(f"K8 {name}: {part} disagrees")
    launches = ops.launch_counts()["fused_window_attention"]
    if launches != len(K8_CASES[::2]):
        raise AssertionError(f"K8 ran {launches} launches")
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="also write every measurement to this JSON file")
    opt = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    details = phase_kernels()
    counts, summary, plain, ref_check = phase_slice()
    train_counts, train_row, gate = phase_train()
    k8_launches = phase_k8()

    # (wrapper, source, TPU kernel, launches on its path)
    sources = {
        "K1": ("fused_window_attention_packed",
               "cobevt_tpu_torch/csrc/window_attention.cu",
               "cobevt_tpu/ops/window_attention.py:832"),
        "K2": ("fused_cross_view_attention",
               "cobevt_tpu_torch/csrc/fused_cross_attention.cu",
               "cobevt_tpu/ops/fused_cross_attention.py:465"),
        "K3": ("fused_conv3x3", "cobevt_tpu_torch/csrc/conv3x3.cu",
               "cobevt_tpu/ops/conv2d.py:141"),
        "K4": ("fused_swap_fusion",
               "cobevt_tpu_torch/csrc/fused_swap_fusion.cu",
               "cobevt_tpu/ops/fused_swap_fusion.py:232"),
        "K5": ("fused_window_attention_packed_bwd",
               "cobevt_tpu_torch/csrc/window_attention_bwd.cu",
               "cobevt_tpu/ops/window_attention.py:671"),
        "K8": ("fused_window_attention",
               "cobevt_tpu_torch/csrc/window_attention.cu",
               "cobevt_tpu/ops/window_attention.py:899"),
    }
    launches = dict(counts)
    launches["fused_window_attention_packed_bwd"] = train_counts[
        "fused_window_attention_packed_bwd"]
    launches["fused_window_attention"] = k8_launches
    kernels = []
    for key, (fn, src, replaces) in sources.items():
        rows = [r for r in details if r["kernel"] == key]
        # one 5-agent frame's calls on the fused serving path (K1-K4), one
        # train step's calls (K5), one call at each shape (K8), bf16
        bf16 = [r for r in rows
                if r["dtype"] == "bfloat16" and r["per_frame"]]

        def total(field):
            return sum(r[field] * r["per_frame"] for r in bf16)

        library = None
        if all(r.get("library_ms") is not None for r in bf16):
            library = total("library_ms")
        if launches[fn] <= 0:
            raise AssertionError(f"{fn} was launched no time on its path")
        kernels.append({
            "name": fn, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[fn],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                         else "operations"),
            "library_ms": library,
        })
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            json.dump({"cases": details, "serve": summary,
                       "serve_plain": plain, "reference": ref_check,
                       "train": train_row, "train_counts": train_counts,
                       "gradient_gate": gate, "kernels": kernels, "card": card_line(),
                       "torch": torch.__version__,
                       "cuda": torch.version.cuda,
                       "seconds": time.perf_counter() - t0}, f, indent=1)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

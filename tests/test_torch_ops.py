"""Kernels of the port (K1 packed window attention, K3 fused conv3x3):
their plain PyTorch versions against the JAX kernels run in interpret
mode and against the JAX XLA references, plus the dispatch rules.

On the CPU a wrapper runs its plain version; the CUDA kernels themselves
are compared with it on the card (tests/test_torch_kernels_gpu.py and
chip_smoke.py).  Tolerances: f32 throughout; 2e-5 abs / 1e-5 rel for
attention (softmax sums in another order), 1e-4 abs / 1e-4 rel for the
conv (sums of up to 9*128 products in another order).
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.ops.conv2d import _xla_reference as jax_conv_reference
from cobevt_tpu.ops.conv2d import fold_bn as jax_fold_bn
from cobevt_tpu.ops.conv2d import fused_conv3x3 as jax_fused_conv3x3
from cobevt_tpu.ops.window_attention import _packed_forward_core
from cobevt_tpu.ops.window_attention import (
    fused_window_attention_packed as jax_fwa_packed,
)
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.conv2d import fold_bn, fused_conv3x3
from cobevt_tpu_torch.ops.window_attention import (
    fused_window_attention_packed,
)
from tests.torch_parity import assert_close

ATTN_TOL = dict(atol=2e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)


def packed_data(G=3, H=4, Tq=24, Tk=40, D=16, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(G, Tq, H * D).astype(np.float32) * 0.3
    k = rng.randn(G, Tk, H * D).astype(np.float32) * 0.3
    v = rng.randn(G, Tk, H * D).astype(np.float32) * 0.3
    bias = rng.randn(Tq, H * Tk).astype(np.float32) * 0.5
    mask = (rng.rand(G, Tk) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    weight = ((rng.rand(G, Tq, H * Tk) > 0.25) / 0.75).astype(np.float32)
    return q, k, v, bias, mask, weight


def _k1_both(q, k, v, H, bias=None, mask=None, weight=None):
    port = fused_window_attention_packed(
        *(torch.from_numpy(t) for t in (q, k, v)), H,
        bias_flat=None if bias is None else torch.from_numpy(bias),
        mask=None if mask is None else torch.from_numpy(mask),
        weight=None if weight is None else torch.from_numpy(weight))
    j = [None if t is None else jnp.asarray(t)
         for t in (q, k, v, bias, mask, weight)]
    kernel = jax_fwa_packed(j[0], j[1], j[2], H, bias_flat=j[3], mask=j[4],
                            weight=j[5], interpret=True)
    xla = _packed_forward_core(*j, H, use_pallas=False, interpret=False)
    return port, kernel, xla


@pytest.mark.parametrize("use_bias,use_mask,use_weight", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, False), (True, False, True), (False, False, True)])
@pytest.mark.parametrize("D", [16, 32])
def test_k1_plain_matches_jax(use_bias, use_mask, use_weight, D):
    q, k, v, bias, mask, weight = packed_data(D=D)
    port, kernel, xla = _k1_both(q, k, v, 4, bias if use_bias else None,
                                 mask if use_mask else None,
                                 weight if use_weight else None)
    assert_close(port, kernel, **ATTN_TOL)
    assert_close(port, xla, **ATTN_TOL)


def test_k1_fully_masked_window_gives_uniform_weights():
    q, k, v, bias, mask, _ = packed_data()
    mask[1] = 0.0                     # every key of window 1 masked
    port, kernel, xla = _k1_both(q, k, v, 4, bias, mask)
    assert torch.isfinite(port).all()
    assert_close(port, kernel, **ATTN_TOL)
    assert_close(port, xla, **ATTN_TOL)
    # -1e9 swamps q.k + bias in f32: every key gets the same weight
    mean_v = v[1].mean(axis=0)
    np.testing.assert_allclose(port[1].numpy(),
                               np.broadcast_to(mean_v, port[1].shape),
                               atol=1e-6)


def test_k1_rejects_weight_with_mask():
    q, k, v, _, mask, weight = packed_data()
    with pytest.raises(ValueError, match="weight\\+mask"):
        fused_window_attention_packed(
            *(torch.from_numpy(t) for t in (q, k, v)), 4,
            mask=torch.from_numpy(mask), weight=torch.from_numpy(weight))


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 128, 128),      # a stride-1 trunk block, C = O
    (1, 6, 10, 32, 64),       # non-square, O != C
])
@pytest.mark.parametrize("residual,relu", [(False, True), (True, True),
                                           (True, False)])
def test_k3_plain_matches_jax(shape, residual, relu):
    N, H, W, C, O = shape
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, O) * 0.05).astype(np.float32)
    b = rng.randn(O).astype(np.float32)
    r = rng.randn(N, H, W, O).astype(np.float32) if residual else None
    port = fused_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b),
                         None if r is None else torch.from_numpy(r),
                         relu=relu)
    jr = None if r is None else jnp.asarray(r)
    kernel = jax_fused_conv3x3(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), jr, relu=relu, interpret=True)
    xla = jax_conv_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jr, relu)
    assert_close(port, kernel, **CONV_TOL)
    assert_close(port, xla, **CONV_TOL)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(1)
    kernel = rng.randn(3, 3, 16, 8).astype(np.float32)
    scale, bias, mean = (rng.randn(8).astype(np.float32) for _ in range(3))
    var = (rng.rand(8) + 0.5).astype(np.float32)
    args = (kernel, scale, bias, mean, var)
    w, t = fold_bn(*(torch.from_numpy(a) for a in args))
    jw, jt = jax_fold_bn(*(jnp.asarray(a) for a in args))
    assert_close(w, jw, atol=1e-6, rtol=1e-6)
    assert_close(t, jt, atol=1e-6, rtol=1e-6)


def test_cpu_tensors_run_plain_versions_without_launching():
    q, k, v, bias, _, _ = packed_data()
    ops.reset_launch_counts()
    fused_window_attention_packed(
        *(torch.from_numpy(t) for t in (q, k, v)), 4,
        bias_flat=torch.from_numpy(bias))
    x = torch.randn(1, 4, 4, 16)
    fused_conv3x3(x, torch.randn(3, 3, 16, 16), torch.zeros(16))
    assert ops.launch_counts() == {"fused_window_attention_packed": 0,
                                   "fused_cross_view_attention": 0,
                                   "fused_conv3x3": 0,
                                   "fused_swap_fusion": 0,
                                   "fused_window_attention_packed_bwd": 0,
                                   "fused_window_attention": 0,
                                   "fused_swap_fusion_streaming": 0,
                                   "fused_conv3x3_int8": 0, "conv3x3_s8": 0,
                                   "bn_stats_fwd": 0, "bn_stats_bwd": 0,
                                   "fused_ffd": 0, "fused_ffd_bwd": 0}


def test_kernel_impl_on_cpu_raises():
    q, k, v, _, _, _ = packed_data()
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        fused_window_attention_packed(qt, kt, vt, 4, impl="kernel")
    x = torch.randn(1, 4, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv3x3(x, torch.randn(3, 3, 16, 16), torch.zeros(16),
                      impl="kernel")
    with ops.forced_impl("kernel"):
        with pytest.raises(ValueError, match="CUDA"):
            fused_window_attention_packed(qt, kt, vt, 4)
    with ops.forced_impl("torch"):
        out = fused_window_attention_packed(qt, kt, vt, 4)
    assert out.shape == qt.shape
    with pytest.raises(ValueError, match="impl"):
        fused_conv3x3(x, torch.randn(3, 3, 16, 16), torch.zeros(16),
                      impl="cudnn")


def test_kernel_build_targets_hopper_from_package_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    for name in ("window_attention", "conv3x3"):
        src = _build.source_path(name)
        assert os.path.isfile(src)
        with open(src) as f:
            text = f.read()
        assert f'extern "C" int cobevt_{name}(' in text
        assert "torch/extension.h" not in text
    assert os.path.commonpath([_build.BUILD_DIR, _build.CSRC_DIR]) == \
        os.path.dirname(_build.CSRC_DIR)

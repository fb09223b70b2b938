"""The port's int8 microbenchmark against the JAX tool's arithmetic.

``cobevt_tpu/tools/quant_microbench.py`` builds its functions inside
``bench_dot`` and ``bench_conv``, so they cannot be imported; they are
restated here in ``jax.numpy``, line for line (``f_int8`` :83-92,
``f_int8_static`` :94-100, the conv ``f_int8`` :133-142, the weight
quantization :76-78 and :123-125), with the final bf16 cast left out so the
f32 rescale is compared.  Inputs are seeded numpy normals in f32 at small
shapes.  Tolerance: the quantized operands and the int32 accumulators
exact, the rescaled outputs within 1e-6 of the largest.  The conv the tool
runs, K7, is held to the JAX package's K7 twin, whose quantization it
follows.  The library
products and kernels themselves are held to these plain versions on the
card (``chip_smoke.py`` phase 23).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cobevt_tpu.ops import conv2d as jax_conv2d
from cobevt_tpu_torch.ops.conv2d import conv3x3_s32, pack_int8_weight
from cobevt_tpu_torch.tools import quant_microbench as qm

RESCALE_TOL = 1e-6


def jax_quantize_activation(a):
    # quant_microbench.py:85-87
    s_a = jnp.max(jnp.abs(a).astype(jnp.float32)) / 127.0
    a_q = jnp.clip(jnp.round(a.astype(jnp.float32) / s_a),
                   -127, 127).astype(jnp.int8)
    return a_q, s_a


def jax_dot_weight(w):
    # quant_microbench.py:76-78
    s_w = jnp.max(jnp.abs(w).astype(jnp.float32), axis=0) / 127.0
    w_q = jnp.clip(jnp.round(w.astype(jnp.float32) / s_w[None, :]),
                   -127, 127).astype(jnp.int8)
    return w_q, s_w


def jax_conv_weight(w):
    # quant_microbench.py:123-125
    s_w = jnp.max(jnp.abs(w).astype(jnp.float32), axis=(0, 1, 2)) / 127.0
    w_q = jnp.clip(jnp.round(w.astype(jnp.float32) / s_w), -127,
                   127).astype(jnp.int8)
    return w_q, s_w


def jax_dot_int8(a, w_q, s_w):
    # f_int8, quant_microbench.py:83-92, without the bf16 cast
    a_q, s_a = jax_quantize_activation(a)
    acc = lax.dot_general(a_q, w_q, (((1,), (0,)), ((), ())),
                          preferred_element_type=jnp.int32)
    return acc, acc.astype(jnp.float32) * (s_a * s_w)[None, :]


def jax_dot_int8_static(a, w_q):
    # f_int8_static, quant_microbench.py:94-100
    return lax.dot_general(a.astype(jnp.int8), w_q,
                           (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)


def jax_conv_int8(a, w_q, s_w):
    # f_int8 of bench_conv, quant_microbench.py:133-142, without the cast
    a_q, s_a = jax_quantize_activation(a)
    acc = lax.conv_general_dilated(
        a_q, w_q, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return acc, acc.astype(jnp.float32) * (s_a * s_w)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RESCALE_TOL * np.abs(want).max()


@pytest.mark.parametrize("M,K,N", [(64, 128, 96), (48, 256, 32),
                                   (40, 128, 128)])
def test_dense_int8_matches_the_jax_tool(M, K, N):
    rng = np.random.RandomState(0)
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randn(K, N).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jw_q, js_w = jax_dot_weight(jnp.asarray(w))
    w_q, s_w = qm.quantize_weight(tw)
    assert np.array_equal(w_q.numpy(), np.asarray(jw_q))
    assert np.array_equal(s_w.numpy(), np.asarray(js_w))
    w_q_t = w_q.t().contiguous()

    a_q, _ = qm.quantize_activation(tx)
    ja_q, _ = jax_quantize_activation(jnp.asarray(x))
    assert np.array_equal(a_q.numpy(), np.asarray(ja_q))
    jacc, jout = jax_dot_int8(jnp.asarray(x), jw_q, js_w)
    acc = qm.int_product(a_q, w_q_t)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    _close(qm.dot_int8(tx, w_q_t, s_w, out_dtype=torch.float32).numpy(),
           jout)

    static = qm.dot_int8_static(tx, w_q_t)
    assert np.array_equal(static.numpy(),
                          np.asarray(jax_dot_int8_static(jnp.asarray(x),
                                                         jw_q)))


@pytest.mark.parametrize("N,H,W,C,O", [(2, 8, 8, 128, 128),
                                       (2, 6, 10, 256, 64),
                                       (1, 4, 4, 512, 64),
                                       (2, 12, 12, 64, 64)])
def test_int8_conv_matches_the_jax_tool(N, H, W, C, O):
    """The tool's plain int8 conv against the JAX tool's arithmetic step by
    step, and the conv the tool runs, K7 (its plain version on the CPU),
    against the JAX package's K7 twin (``cobevt_tpu/ops/conv2d.py:
    _xla_reference_int8``).  The two JAX functions quantize differently:
    K7 multiplies by ``1 / s_a``, the tool divides by ``s_a``.  In f32 the
    two can round an activation one tick apart where ``x / s_a`` lies
    within an ulp of a half-integer (the inputs at (2, 6, 10, 256) hold
    one); the test bounds that gap."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = rng.randn(3, 3, C, O).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx = jnp.asarray(x)
    jw_q, js_w = jax_conv_weight(jnp.asarray(w))
    packed = pack_int8_weight(tw, torch.zeros(O))
    assert np.array_equal(packed.w_q.numpy(), np.asarray(jw_q))
    assert np.array_equal(packed.s_w.numpy(), np.asarray(js_w))

    jacc, jout = jax_conv_int8(jx, jw_q, js_w)
    a_q, _ = qm.quantize_activation(tx)
    acc = conv3x3_s32(a_q, packed.w_q)
    assert np.array_equal(acc.numpy(), np.asarray(jacc))
    _close(qm.conv_int8_plain(tx, packed.w_q, packed.s_w,
                              out_dtype=torch.float32).numpy(), jout)

    s_a = jax_conv2d._act_scale(jx)
    k7 = qm.conv_k7(tx, packed)
    assert k7.dtype == torch.float32
    _close(k7.numpy(), jax_conv2d._xla_reference_int8(
        jx, jw_q, js_w, s_a, jnp.zeros(O), None, False))
    ticks_k7 = np.round(x * np.float32(1.0 / np.float32(s_a)))
    ticks_tool = np.asarray(jax_quantize_activation(jx)[0], np.float32)
    apart = np.abs(np.clip(ticks_k7, -127, 127) - ticks_tool)
    assert apart.max() <= 1 and apart.mean() <= 1e-4


def test_cpu_run_checks_every_row():
    rows = qm.run(torch.device("cpu"), iters=0)
    assert [r["shape"].split()[0] for r in rows] == (
        ["64x32@32x48", "32x64@64x16", "conv3x3", "layer1"])
    assert qm.failed_checks(rows) == []
    assert all("bf16_us" not in r and "cudnn_us" not in r for r in rows)

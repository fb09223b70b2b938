"""K11 and K12 (fused PreNorm feed-forward and its recompute backward) of
the port against the JAX tool.

The plain versions of ``cobevt_tpu_torch/ops/ffd_fused.py`` against the
Pallas bodies of ``cobevt_tpu/tools/micro_ffd_fused.py`` in interpret mode
(``_pallas_fwd``, ``_pallas_bwd``) and against the tool's erf oracle
(``ref_ffd`` and its ``jax.grad``), on the same numpy inputs.

Tolerances.  Against the Pallas bodies (the same arithmetic, the same erf
polynomial): 2e-6 of the largest value in f32 (sums in another order); in
bf16 outputs may differ by one bf16 step where a cast falls on the other
side (2^-7 of the largest value) and the f32 sums by 2e-2 of theirs.
Against the erf oracle: the tool's own measures, 2e-3 for the forward's
largest relative error (denominator |out| + 1e-3) and 1e-4 relative L2 per
gradient.  The CUDA kernels themselves are held to the plain versions on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.tools import micro_ffd_fused as jax_tool
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import ffd_fused
from cobevt_tpu_torch.ops.ffd_fused import (
    ffd_backward_reference,
    ffd_reference,
    fused_ffd,
    fused_ffd_bwd,
)
from cobevt_tpu_torch.tools import micro_ffd_fused

NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def operands(N, D, M, seed=0):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(N, D) * 0.3, rng.rand(D) + 0.5, rng.randn(D) * 0.1,
        rng.randn(D, M) * 0.05, rng.randn(M) * 0.1, rng.randn(M, D) * 0.05,
        rng.randn(D) * 0.1, rng.randn(N, D))]


def both(arrays, dtype):
    """The operands as torch and as JAX arrays: x, w1, w2 and dy in
    ``dtype``, the vectors in f32."""
    in_dtype = (0, 3, 5, 7)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) if i in in_dtype
         else torch.from_numpy(a) for i, a in enumerate(arrays)]
    j = [jnp.asarray(a, dtype) if i in in_dtype else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    return t, j


def close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("shape", [(256, 64, 128), (128, 128, 64)])
def test_plain_forward_matches_the_pallas_body(dtype, tol, shape):
    t, j = both(operands(*shape), dtype)
    got = ffd_reference(*t[:7])
    assert got.dtype == t[0].dtype
    close(got, jax_tool._pallas_fwd(*j[:7], 64, True), tol)


@pytest.mark.parametrize("dtype,tol_x,tol_sum", [
    ("float32", 2e-6, 2e-5), ("bfloat16", 2.0 ** -7, 2e-2)])
@pytest.mark.parametrize("shape", [(256, 64, 128), (128, 128, 64)])
def test_plain_backward_matches_the_pallas_body(dtype, tol_x, tol_sum, shape):
    t, j = both(operands(*shape), dtype)
    x, gamma, beta, w1, b1, w2, _, dy = t
    jx, jg, jb, jw1, jb1, jw2, _, jdy = j
    got = ffd_backward_reference(x, dy, gamma, beta, w1, b1, w2)
    want = jax_tool._pallas_bwd(jx, jdy, jg, jb, jw1, jb1, jw2, 64, True)
    assert got[0].dtype == x.dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(NAMES, got, want):
        close(g, w, tol_x if name == "dx" else tol_sum)


def test_plain_versions_match_the_erf_oracle():
    t, j = both(operands(192, 64, 128), "float32")
    want = jax_tool.ref_ffd(*j[:7])
    got = ffd_reference(*t[:7])
    rel = np.abs(got.numpy() - np.asarray(want)) / (np.abs(want) + 1e-3)
    assert rel.max() <= 2e-3

    def loss(*a):
        return (jax_tool.ref_ffd(*a) ** 2).sum()

    grads = jax.grad(loss, argnums=tuple(range(7)))(*j[:7])
    leaves = [a.clone().requires_grad_(True) for a in t[:7]]
    (fused_ffd(*leaves) ** 2).sum().backward()
    for name, leaf, want in zip(NAMES, leaves, grads):
        want = np.asarray(want)
        err = np.linalg.norm(leaf.grad.numpy() - want) / (
            np.linalg.norm(want) + 1e-9)
        assert err <= 1e-4, (name, err)


def test_cast_points_are_roundings_in_bf16():
    """t, a, gc and dh are rounded to bf16 before their products: the plain
    versions differ from an all-f32 evaluation of the same operands by far
    more than they differ from the Pallas body."""
    arrays = operands(128, 64, 128)
    t, j = both(arrays, "bfloat16")
    x, gamma, beta, w1, b1, w2, b2, dy = t
    got = ffd_backward_reference(x, dy, gamma, beta, w1, b1, w2)
    f32 = ffd_backward_reference(x.float(), dy.float(), gamma, beta,
                                 w1.float(), b1, w2.float())
    body = jax_tool._pallas_bwd(j[0], j[7], j[1], j[2], j[3], j[4], j[5], 64,
                                True)
    dw1, dw1_f32 = got[3], f32[3]
    dw1_body = torch.from_numpy(np.array(body[3]))
    to_f32 = float((dw1 - dw1_f32).abs().max())
    to_body = float((dw1 - dw1_body).abs().max())
    assert to_f32 > 1e-3 and to_body < to_f32 / 4


def test_row_tail_and_autograd_function():
    """N need not divide a row tile: 200 rows equal the first 200 of 256,
    and the autograd function's gradients are the backward's, cast to the
    parameters' dtypes."""
    full, _ = both(operands(256, 64, 128), "float32")
    x, gamma, beta, w1, b1, w2, b2, dy = full
    cut = ffd_reference(x[:200], gamma, beta, w1, b1, w2, b2)
    torch.testing.assert_close(cut, ffd_reference(*full[:7])[:200],
                               atol=1e-6, rtol=1e-6)
    leaves = [a.clone().requires_grad_(True)
              for a in (x[:200], gamma, beta, w1, b1, w2, b2)]
    ops.reset_launch_counts()
    fused_ffd(*leaves).backward(dy[:200])
    want = fused_ffd_bwd(x[:200], dy[:200], gamma, beta, w1, b1, w2)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        torch.testing.assert_close(leaf.grad, w.to(leaf.dtype))
    counts = ops.launch_counts()
    assert counts["fused_ffd"] == counts["fused_ffd_bwd"] == 0


@pytest.mark.parametrize("shape,ok", [
    ((84480, 256, 512), True), ((1000, 64, 128), True),
    ((1024, 256, 1024), True), ((1024, 512, 512), False),
    ((1024, 96, 128), False), ((1024, 64, 96), False)])
def test_kernel_gate_and_plan(shape, ok):
    N, D, M = shape
    assert ffd_fused.ffd_kernel_accepts(N, D, M, torch.bfloat16) is ok
    assert not ffd_fused.ffd_kernel_accepts(N, D, M, torch.float16)
    if ok:
        plan = ffd_fused.ffd_plan(N, D, M, torch.bfloat16)
        assert plan.route == ("wgmma" if D in (128, 256) and M % 128 == 0
                              else "rows")
        if plan.route == "rows":
            # 16-row blocks; splits x 32-column slices in two waves
            assert 1 <= plan.blocks <= 264 and plan.blocks <= -(-N // 16)
            assert 1 <= plan.splits and plan.splits * (M // 32) <= 264
        else:
            # pairs of 64-row tiles; splits x output tiles in one wave
            assert 1 <= plan.blocks <= 132
            assert plan.blocks <= -(-N // (2 * plan.tile_rows))
            assert 1 <= plan.splits
            assert plan.splits * ffd_fused.weight_tiles(D, M) <= 132
            assert max(plan.fwd_smem, plan.rows_smem,
                       plan.weight_smem) <= 232448


def test_kernel_impl_on_cpu_raises():
    t, _ = both(operands(64, 64, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ffd(*t[:7], impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ffd_bwd(t[0], t[7], *t[1:6], impl="kernel")


def test_micro_tool_operands_are_the_jax_tools():
    N, D, M = 32, 256, 512
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(N, D) * 0.3, jnp.float32)
    gamma = jnp.asarray(rng.rand(D) + 0.5, jnp.float32)
    got = micro_ffd_fused.make_operands(N, D, M, torch.float32, "cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(gamma))
    assert [tuple(t.shape) for t in got] == [
        (N, D), (D,), (D,), (D, M), (M,), (M, D), (D,)]


def test_micro_tool_on_the_cpu(capsys):
    assert micro_ffd_fused.main(["--device", "cpu", "--rows", "256"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("fwd max rel:") and len(lines) == 9
    row = json.loads(lines[-1])
    assert row["ok"] and row["device"] == "cpu" and row["clock"] is None
    assert row["shape"] == [256, 256, 512] and row["dtype"] == "float32"
    assert "fused_fwd_bwd_ms" not in row
    assert set(row["parity"]) == {"fwd_max_rel", "fwd_rel_l2", *NAMES}


def test_micro_tool_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert micro_ffd_fused.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err

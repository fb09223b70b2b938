"""The CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  On a machine
with one:

  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

builds K1-K5 and K8 with nvcc (sm_90a) on first use (``--noconftest``: the
repo's conftest sets up JAX, which these tests do not need).  Tolerances: f32
1e-4 abs / 1e-4 rel (sums in another order); bf16 2e-2 abs / 2e-2 rel
(both sides round an f32 result to bf16 once, or at the same casts of one
chain: K2), and for K4 in bf16 5e-2 abs / 2e-2 rel: its residual state is
rounded to bf16 after each of 2*depth sublayers, and a one-ulp flip at
|x| ~ 4 (0.03) carries on through the sublayers after it.  K5's
gradients are sums of up to Tq or Tk terms, so their tolerance scales with
the largest value of the plain version's result: f32 1e-4 of it (sums in
another order), bf16 2e-2 of it (the kernel takes the row maximum per head,
the plain version over all heads as the TPU body does, so the exp rounds to
bf16 at another place: one bf16 ulp on a weight); dbias also sums the
windows with atomics, in any order.
"""

import pytest
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn.layers import BasicBlock
from cobevt_tpu_torch.ops.conv2d import fused_conv3x3
from cobevt_tpu_torch.ops.fused_cross_attention import (
    LAUNCHES_PER_CALL,
    fused_cross_view_attention,
)
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    fused_swap_fusion,
    launches_per_call,
)
from cobevt_tpu_torch.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_packed,
    fused_window_attention_packed_bwd,
    packed_bwd_kernel_ok,
)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
K4_TOL = {torch.float32: TOL[torch.float32],
          torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


@pytest.fixture
def gen():
    """A seeded CUDA generator; TF32 off so the f32 plain versions (cuDNN
    convolutions included) run in full f32 precision."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask",
                                    "bias+weight", "weight"])
def test_k1_kernel_matches_plain(gen, dtype, D, extras):
    G, H, Tq, Tk = 3, 4, 72, 40        # ragged query and key tiles

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, Tq, H * D) * 0.3).to(dtype)
    k, v = rand(G, Tk, H * D).to(dtype), rand(G, Tk, H * D).to(dtype)
    bias = rand(Tq, H * Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0                  # a fully masked window
    weight = None
    if "weight" in extras:
        weight = ((rand(G, Tq, H * Tk) > -1).float() / 0.84).to(dtype)
    before = fused_window_attention_packed.launches
    got = fused_window_attention_packed(q, k, v, H, bias, mask, weight)
    assert fused_window_attention_packed.launches == before + 1
    want = fused_window_attention_packed(q, k, v, H, bias, mask, weight,
                                         impl="torch")
    assert fused_window_attention_packed.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _assert_close_scaled(got, want, dtype, name):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = max(float(want.abs().max()), 1e-3)
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=tol, msg=lambda m: f"{name}: {m}")


def _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, Tq, H * D) * 0.3).to(dtype)
    k, v = rand(G, Tk, H * D).to(dtype), rand(G, Tk, H * D).to(dtype)
    g = rand(G, Tq, H * D).to(dtype)
    bias = rand(Tq, H * Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0                  # a fully masked window
    return q, k, v, g, bias, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
@pytest.mark.parametrize("Tq,Tk", [(72, 40), (128, 192)])
def test_k5_kernel_matches_plain(gen, dtype, D, extras, Tq, Tk):
    G, H = 3, 4                        # (72, 40): ragged tiles
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    before = fused_window_attention_packed_bwd.launches
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    assert fused_window_attention_packed_bwd.launches == before + 1
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask,
                                             impl="torch")
    assert fused_window_attention_packed_bwd.launches == before + 1
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (a is None) == (b is None) == (
            name == "dbias" and bias is None)
        if a is not None:
            assert a.dtype == (torch.float32 if name == "dbias" else dtype)
            _assert_close_scaled(a, b, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extras", ["bias+mask", "bias+weight"])
def test_packed_attention_backward_on_the_card(gen, dtype, extras):
    """autograd through the wrapper: K1 forward and K5 backward (or the
    composite backward with a weight) against the plain versions."""
    G, H, D, Tq, Tk = 3, 4, 32, 64, 64
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras)
    weight = None
    if "weight" in extras:
        weight = ((torch.rand(G, Tq, H * Tk, generator=gen, device="cuda")
                   > 0.2).float() / 0.8).to(dtype)
    grads = {}
    for impl in ("kernel", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        ops.reset_launch_counts()
        out = fused_window_attention_packed(*leaves[:3], H, leaves[3], mask,
                                            weight, impl=impl)
        out.backward(g)
        counts = ops.launch_counts()
        kernel = int(impl == "kernel")
        assert counts["fused_window_attention_packed"] == kernel
        assert counts["fused_window_attention_packed_bwd"] == (
            kernel if packed_bwd_kernel_ok(q, k, weight, H) else 0)
        grads[impl] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads["kernel"],
                          grads["torch"]):
        _assert_close_scaled(a, b, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
def test_k8_kernel_matches_plain(gen, dtype, D, extras):
    G, H, Tq, Tk = 3, 4, 72, 40

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, H, Tq, D) * 0.3).to(dtype)
    k, v = rand(G, H, Tk, D).to(dtype), rand(G, H, Tk, D).to(dtype)
    bias = rand(H, Tq, Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0
    before = fused_window_attention.launches
    got = fused_window_attention(q, k, v, bias, mask)
    assert fused_window_attention.launches == before + 1
    want = fused_window_attention(q, k, v, bias, mask, impl="torch")
    assert fused_window_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 9, 7, 32, 48),          # tensor-core path in bf16
    (1, 16, 16, 128, 128),      # tensor-core path in bf16
    (2, 5, 6, 16, 24),          # C % 32 != 0: scalar path in bf16 too
])
@pytest.mark.parametrize("residual", [False, True])
def test_k3_kernel_matches_plain(gen, dtype, shape, residual):
    N, H, W, C, O = shape
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").to(dtype)
    w = torch.randn(3, 3, C, O, generator=gen, device="cuda") * 0.05
    shift = torch.randn(O, generator=gen, device="cuda")
    res = (torch.randn(N, H, W, O, generator=gen, device="cuda").to(dtype)
           if residual else None)
    got = fused_conv3x3(x, w, shift, res)
    want = fused_conv3x3(x, w, shift, res, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_basic_block_eval_launches_k3_twice(gen):
    block = BasicBlock(128, 128).cuda().eval()
    x = torch.randn(2, 16, 16, 128, generator=gen, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        got = block(x)
        assert ops.launch_counts()["fused_conv3x3"] == 2
        with ops.forced_impl("torch"):
            want = block(x)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_kernel_rejects_what_it_does_not_take(gen):
    q = torch.randn(2, 16, 4 * 24, device="cuda")      # D = 24
    with pytest.raises(ValueError, match="head dims"):
        fused_window_attention_packed(q, q, q, 4)
    x = torch.randn(1, 4, 4, 8, device="cuda")          # C = 8
    with pytest.raises(ValueError, match="C % 16"):
        fused_conv3x3(x, torch.randn(3, 3, 8, 8, device="cuda"),
                      torch.zeros(8, device="cuda"))


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _ln(gen, D):
    return 1.0 + 0.1 * _rand(gen, D), 0.1 * _rand(gen, D)


def k2_operands(gen, B, n, H, W, D, C, h, w, embed, tail):
    x, key, val = (_rand(gen, B, H, W, D), _rand(gen, B, n, h, w, D),
                   _rand(gen, B, n, h, w, D))
    w_embed = _rand(gen, H, W, D) if embed else None
    c_embed = _rand(gen, B, n, D) if embed else None
    params = dict(ln_q=_ln(gen, D), ln_k=_ln(gen, D), ln_v=_ln(gen, D))
    for name, (i, o) in (("q", (D, C)), ("k", (D, C)), ("v", (D, C)),
                         ("o", (C, D))):
        params[f"w{name}"] = _rand(gen, i, o, scale=i ** -0.5)
        params[f"b{name}"] = _rand(gen, o, scale=0.1)
    mlp = post_ln = None
    if tail:
        mlp = {"ln": _ln(gen, D), "w1": _rand(gen, D, 2 * D, scale=D ** -0.5),
               "b1": _rand(gen, 2 * D, scale=0.1),
               "w2": _rand(gen, 2 * D, D, scale=(2 * D) ** -0.5),
               "b2": _rand(gen, D, scale=0.1)}
        post_ln = _ln(gen, D)
    return x, w_embed, c_embed, key, val, params, mlp, post_ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, n, H, W, D, C, h, w, q_win, k_win, heads, embed, tail, grid, skip)
    (2, 4, 32, 32, 128, 128, 16, 16, (8, 8), (4, 4), 4, True, True, False,
     True),
    (2, 4, 32, 32, 128, 128, 16, 16, (8, 8), (4, 4), 4, False, True, True,
     True),
    # a branch without embed or MLP, no skip, head dim 16
    (3, 2, 16, 24, 32, 32, 8, 12, (8, 8), (4, 4), 2, False, False, False,
     False),
    # head dim 8, ragged query tiles (40 rows a window), grid keys
    (1, 3, 20, 16, 64, 64, 8, 8, (10, 4), (4, 2), 8, True, False, True,
     True),
])
def test_k2_kernel_matches_plain(gen, dtype, case):
    B, n, H, W, D, C, h, w, q_win, k_win, heads, embed, tail, grid, skip = \
        case
    x, we, ce, key, val, params, mlp, post_ln = k2_operands(
        gen, B, n, H, W, D, C, h, w, embed, tail)

    def cast(t):
        return None if t is None else t.to(dtype)

    args = (cast(x), cast(we), cast(ce), cast(key), cast(val), params, q_win,
            k_win, heads, (C // heads) ** -0.5, skip)
    before = fused_cross_view_attention.launches
    got = fused_cross_view_attention(*args, mlp=mlp, post_ln=post_ln,
                                     grid_keys=grid)
    assert fused_cross_view_attention.launches == before + LAUNCHES_PER_CALL
    want = fused_cross_view_attention(*args, mlp=mlp, post_ln=post_ln,
                                      grid_keys=grid, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def k4_operands(gen, B, L, H, W, D, w, heads, depth, mlp):
    T = L * w * w

    def layer():
        return {"ln_a": _ln(gen, D), "wqkv": _rand(gen, D, 3 * D,
                                                    scale=D ** -0.5),
                "wout": _rand(gen, D, D, scale=D ** -0.5), "ln_f": _ln(gen, D),
                "w1": _rand(gen, D, mlp, scale=D ** -0.5),
                "b1": _rand(gen, mlp, scale=0.1),
                "w2": _rand(gen, mlp, D, scale=mlp ** -0.5),
                "b2": _rand(gen, D, scale=0.1)}

    layers = [(layer(), layer()) for _ in range(depth)]
    bias = _rand(gen, depth, 2, T, heads * T, scale=0.5)
    head = {"ln": _ln(gen, D), "w": _rand(gen, D, D, scale=D ** -0.5),
            "b": _rand(gen, D, scale=0.1)}
    return _rand(gen, B, L, H, W, D), layers, bias, head


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, L, H, W, D, window, heads, depth, mlp, mask, mean_over_valid)
    (1, 5, 32, 32, 128, 8, 4, 3, 256, "random", False),   # CorpBEVT
    (2, 3, 16, 16, 64, 4, 2, 2, 128, "mostly_masked", True),
    (2, 4, 16, 8, 32, 4, 4, 1, 32, None, True),            # head dim 8
    (1, 2, 8, 24, 32, 4, 2, 2, 48, "random", False),       # head dim 16
])
def test_k4_kernel_matches_plain(gen, dtype, case):
    B, L, H, W, D, w, heads, depth, mlp, mask_kind, valid = case
    x, layers, bias, head = k4_operands(gen, B, L, H, W, D, w, heads, depth,
                                        mlp)
    mask = None
    if mask_kind is not None:
        mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
                > 0.3).float()
        mask[:, 0] = 1.0
        if mask_kind == "mostly_masked":
            # window (0, 0) and grid cell (0, 0) keep one live key each
            mask[:, :, :w, :w] = 0.0
            mask[:, :, ::H // w, ::W // w] = 0.0
            mask[:, 0, 0, 0] = 1.0
    agent_mask = torch.ones(B, L, device="cuda")
    agent_mask[:, -1] = 0.0
    args = (x.to(dtype), mask, agent_mask, bias, layers, head, w, heads, valid)
    before = fused_swap_fusion.launches
    got = fused_swap_fusion(*args)
    assert fused_swap_fusion.launches == before + launches_per_call(depth)
    want = fused_swap_fusion(*args, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dtype])


def test_fused_kernels_reject_what_they_do_not_take(gen):
    x, we, ce, key, val, params, _, _ = k2_operands(
        gen, 1, 2, 16, 16, 64, 64, 8, 8, True, False)
    with pytest.raises(ValueError, match="K2 does not take"):   # head dim 64
        fused_cross_view_attention(x, we, ce, key, val, params, (8, 8),
                                   (4, 4), 1, 1.0)
    x, layers, bias, head = k4_operands(gen, 1, 3, 12, 12, 32, 3, 2, 1, 32)
    with pytest.raises(ValueError, match="K4 does not take"):
        fused_swap_fusion(x, None, None, bias, layers, head, 3, 2)

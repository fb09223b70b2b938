"""The CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  On a machine
with one:

  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

builds K1 and K3 with nvcc (sm_90a) on first use (``--noconftest``: the
repo's conftest sets up JAX, which these tests do not need).  Tolerances: f32
1e-4 abs / 1e-4 rel (sums in another order); bf16 2e-2 abs / 2e-2 rel
(both sides round an f32 result to bf16 once).
"""

import pytest
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn.layers import BasicBlock
from cobevt_tpu_torch.ops.conv2d import fused_conv3x3
from cobevt_tpu_torch.ops.window_attention import (
    fused_window_attention_packed,
)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


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

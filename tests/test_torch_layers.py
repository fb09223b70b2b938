"""Port layers, ResNet trunk and geometry against the JAX package.

Same numpy weights (via the weight bridge) and inputs on both sides, f32
on the CPU.  Tolerances: 1e-5 abs/rel for single layers, 1e-4 for the
ResNet-18 encoder (sums in another order through 8 blocks); geometry is
exact up to f32 rounding (1e-5).
"""

import numpy as np
import pytest
import flax.linen as fnn
import jax.numpy as jnp
import torch

from cobevt_tpu.geometry import transforms as jt
from cobevt_tpu.geometry import warp as jw
from cobevt_tpu.nn import layers as jl
from cobevt_tpu.nn.resnet import ResNetEncoder as JaxResNetEncoder
from cobevt_tpu_torch.geometry import transforms as pt
from cobevt_tpu_torch.geometry import warp as pw
from cobevt_tpu_torch.nn import layers as pl
from cobevt_tpu_torch.nn.resnet import ResNetEncoder
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def test_images_from_uint8_and_gelu():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    assert_close(pl.images_from_uint8(torch.from_numpy(img)),
                 jl.images_from_uint8(jnp.asarray(img)), **TOL)
    f = rng.rand(2, 3).astype(np.float32)
    assert pl.images_from_uint8(torch.from_numpy(f)).dtype == torch.float32
    x = rng.randn(64).astype(np.float32) * 3
    assert_close(pl.gelu(torch.from_numpy(x)), jl.gelu(jnp.asarray(x)),
                 **TOL)


def test_norm_eps_pinned():
    assert pl.batch_norm(8).eps == 1e-5 and pl.batch_norm(8).momentum == 0.1
    assert pl.layer_norm(8).eps == 1e-5


@pytest.mark.parametrize("cin,planes,stride,fused_env", [
    (128, 128, 1, "1"),     # K3 path (plain version on the CPU)
    (128, 128, 1, "0"),     # COBEVT_FUSED_CONV=0: stock convs
    (64, 64, 1, "1"),       # below the 128-channel gate
    (64, 128, 2, "1"),      # strided block with downsample
])
def test_basic_block_eval(monkeypatch, cin, planes, stride, fused_env):
    monkeypatch.setenv("COBEVT_FUSED_CONV", fused_env)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    down = stride != 1 or cin != planes
    jm = jl.BasicBlock(planes, stride, downsample=down)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(pl.BasicBlock(cin, planes, stride, down), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, jax_apply(jm, v, jnp.asarray(x), False), **TOL)


def test_basic_block_train_mode_uses_batch_stats():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 128).astype(np.float32)
    jm = jl.BasicBlock(128, 1)
    v = jax_variables(jm, jnp.asarray(x), False)
    want, _ = jax_apply(jm, v, jnp.asarray(x), True, mutable=["batch_stats"])
    port = port_from(pl.BasicBlock(128, 128), v).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_bottleneck_eval():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    jm = jl.Bottleneck(8)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(pl.Bottleneck(32, 8), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, jax_apply(jm, v, jnp.asarray(x), False), **TOL)


def test_pixel_unshuffle_and_mlp_seq():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 6, 3).astype(np.float32)
    assert_close(pl.pixel_unshuffle(torch.from_numpy(x), 2),
                 jl.pixel_unshuffle(jnp.asarray(x), 2), atol=0, rtol=0)
    # torch's own PixelUnshuffle agrees on channel order
    ref = torch.nn.PixelUnshuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(ref.permute(0, 2, 3, 1),
                       pl.pixel_unshuffle(torch.from_numpy(x), 2))

    class JaxMlp(fnn.Module):
        @fnn.compact
        def __call__(self, t):
            return jl.mlp_seq(t, 24, 8, prefix="mlp")

    class PortMlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = pl.mlp_seq(16, 24, 8)

        def forward(self, t):
            return self.mlp(t)

    t = rng.randn(5, 16).astype(np.float32)
    v = jax_variables(JaxMlp(), jnp.asarray(t))
    with torch.no_grad():
        got = port_from(PortMlp(), v)(torch.from_numpy(t))
    assert_close(got, jax_apply(JaxMlp(), v, jnp.asarray(t)), **TOL)


def test_resnet18_encoder_eval():
    rng = np.random.RandomState(5)
    images = rng.rand(1, 2, 1, 64, 64, 3).astype(np.float32)
    jm = JaxResNetEncoder(18, (1, 2, 3))
    v = jax_variables(jm, jnp.asarray(images), False)
    port = port_from(ResNetEncoder(18, (1, 2, 3)), v)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    want = jax_apply(jm, v, jnp.asarray(images), False)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert ResNetEncoder.output_shapes(34, (1, 2, 3), (512, 512)) == \
        JaxResNetEncoder.output_shapes(34, (1, 2, 3), (512, 512))


def _transforms(L=3, seed=0):
    rng = np.random.RandomState(seed)
    tmat = np.tile(np.eye(4, dtype=np.float32), (1, L, 1, 1))
    for l in range(1, L):
        a = rng.uniform(-0.4, 0.4)
        tmat[0, l, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        tmat[0, l, :2, 3] = rng.uniform(-6, 6, 2)
    return tmat


def test_transforms_match_jax():
    tmat = _transforms()
    np.testing.assert_array_equal(pt.get_view_matrix(64, 48, 100, 90, 0.1),
                                  jt.get_view_matrix(64, 48, 100, 90, 0.1))
    np.testing.assert_array_equal(pt.generate_grid(5, 7),
                                  jt.generate_grid(5, 7))
    M = pt.discretize_transformation(torch.from_numpy(tmat), 0.39, 8)
    jM = jt.discretize_transformation(jnp.asarray(tmat), 0.39, 8)
    assert_close(M, jM, **TOL)
    assert_close(pt.affine_from_discretized(M, (16, 24)),
                 jt.affine_from_discretized(jM, (16, 24)), **TOL)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_affine_matches_jax(mode):
    rng = np.random.RandomState(6)
    src = rng.randn(2, 12, 10, 3).astype(np.float32)
    a = 0.3
    M = np.array([[[np.cos(a), -np.sin(a), 1.7], [np.sin(a), np.cos(a), -2.2]],
                  [[1.0, 0.0, 0.5], [0.0, 1.0, 3.25]]], np.float32)
    got = pw.warp_affine(torch.from_numpy(src), torch.from_numpy(M), (12, 10),
                         mode=mode)
    want = jw.warp_affine(jnp.asarray(src), jnp.asarray(M), (12, 10),
                          mode=mode)
    assert_close(got, want, **TOL)


def test_sttf_warp_and_roi_mask_match_jax():
    rng = np.random.RandomState(7)
    tmat = _transforms(seed=1)
    x = rng.randn(1, 3, 16, 16, 4).astype(np.float32)
    agent_mask = np.array([[1.0, 1.0, 0.0]], np.float32)
    got = pw.sttf_warp(torch.from_numpy(x), torch.from_numpy(tmat),
                       0.390625, 8)
    want = jw.sttf_warp(jnp.asarray(x), jnp.asarray(tmat), 0.390625, 8)
    assert_close(got, want, **TOL)
    got_m = pw.roi_and_agent_mask((1, 3, 16, 16), torch.from_numpy(agent_mask),
                                  torch.from_numpy(tmat), 0.390625, 8)
    want_m = jw.roi_and_agent_mask((1, 3, 16, 16), jnp.asarray(agent_mask),
                                   jnp.asarray(tmat), 0.390625, 8)
    assert_close(got_m, want_m, atol=0, rtol=0)
    assert 0 < float(got_m[0, 1].mean()) < 1     # the warp cut the ROI

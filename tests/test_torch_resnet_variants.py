"""The ResNet encoder variants in the port against the JAX package: the
torchvision-style ``FeaturePyramidNetwork``, ``ResNetEncoderSingle`` and
``ResNetEncoderConcat`` (without and with the FPN) at 64^2 images.

Same numpy weights (through the weight bridge) and inputs on both sides,
f32 on the CPU, eval mode (the trunk's stride-1 blocks take K3's plain
version here, as on the card they take K3).  Tolerances: the FPN 1e-5
abs/rel (two convs a level); the encoders 1e-4 abs/rel (the ResNet trunk's
conv stack).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.nn import resnet_variants as jr
from cobevt_tpu_torch.nn import resnet_variants as pr
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)


def _images(seed=5):
    # B 1, 2 agents, 1 camera
    return np.random.RandomState(seed).rand(1, 2, 1, 64, 64, 3).astype(
        np.float32)


def test_feature_pyramid_network_matches():
    rng = np.random.RandomState(0)
    feats = [rng.randn(2, 16 // 2 ** i, 16 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((8, 12, 16))]
    jm = jr.FeaturePyramidNetwork(10)
    v = jax_variables(jm, [jnp.asarray(f) for f in feats])
    port = port_from(pr.FeaturePyramidNetwork((8, 12, 16), 10), v)
    want = jax_apply(jm, v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [(2, 16, 16, 10), (2, 8, 8, 10),
                                             (2, 4, 4, 10)]
    for g, w in zip(got, want):
        assert_close(g, w, **TOL)


def test_resnet_encoder_single_matches():
    images = _images()
    jm = jr.ResNetEncoderSingle(18, id_pick=1)
    v = jax_variables(jm, jnp.asarray(images), False)
    port = port_from(pr.ResNetEncoderSingle(18, id_pick=1), v)
    want = jax_apply(jm, v, jnp.asarray(images), False)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.shape == (1, 2, 1, 8, 8, 128)
    assert_close(got, want, **CONV_TOL)


@pytest.mark.parametrize("fpn_out_dim", [0, 32])
def test_resnet_encoder_concat_matches(fpn_out_dim):
    images = _images(6)
    jm = jr.ResNetEncoderConcat(18, fpn_out_dim=fpn_out_dim,
                                conv_output_dim=24)
    v = jax_variables(jm, jnp.asarray(images), False, seed=fpn_out_dim)
    port = port_from(pr.ResNetEncoderConcat(18, fpn_out_dim=fpn_out_dim,
                                            conv_output_dim=24), v)
    want = jax_apply(jm, v, jnp.asarray(images), False)
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.shape == (1, 2, 1, 8, 8, 24)
    assert_close(got, want, **CONV_TOL)

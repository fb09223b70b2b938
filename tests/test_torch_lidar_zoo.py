"""The LiDAR zoo's BEV backbones in the port against the JAX package:
``AutoEncoder`` and ``AttBEVBackbone`` (attention fusion of the agents at
every scale, with and without the autoencoder compression), and the
padded-agent invariance of ``tests/test_voxel_backbone.py:58``.

Same numpy weights (through the weight bridge) and inputs on both sides,
f32 on the CPU.  Tolerances: the autoencoder 1e-5 abs/rel (two convs a
side); ``AttBEVBackbone`` 1e-4 abs/rel (a conv stack with BatchNorms and
an attention a scale); the padded agent's invariance 1e-5 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.models.lidar import bev_backbone as jb
from cobevt_tpu_torch.models.lidar import bev_backbone as pb
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
ATT_ARGS = dict(layer_nums=(1, 1), layer_strides=(2, 2),
                num_filters=(16, 32), upsample_strides=(1, 2),
                num_upsample_filter=(16, 16))


@pytest.mark.parametrize("layers", [1, 2])
def test_auto_encoder_matches(layers):
    rng = np.random.RandomState(layers)
    x = rng.randn(3, 8, 12, 16).astype(np.float32)
    jm = jb.AutoEncoder(16, layers)
    v = jax_variables(jm, jnp.asarray(x), seed=layers)
    port = port_from(pb.AutoEncoder(16, layers), v)
    want = jax_apply(jm, v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (3, 8, 12, 16)
    assert_close(got, want, **TOL)


def _att_inputs(seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 3, 16, 16, 8).astype(np.float32)
    mask = np.array([[1.0, 1.0, 0.0]], np.float32)
    return x, mask


@pytest.mark.parametrize("compression", [0, 1])
def test_att_bev_backbone_matches(compression):
    x, mask = _att_inputs()
    jm = jb.AttBEVBackbone(**ATT_ARGS, compression=compression)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(mask), False,
                      seed=3 + compression)
    port = port_from(pb.AttBEVBackbone(8, **ATT_ARGS,
                                       compression=compression), v)
    want = jax_apply(jm, v, jnp.asarray(x), jnp.asarray(mask), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (1, 8, 8, 32)
    assert_close(got, want, **CONV_TOL)

    # a padded agent must not change the fused output
    x2 = x.copy()
    x2[:, 2] = 123.0
    with torch.no_grad():
        got2 = port(torch.from_numpy(x2), torch.from_numpy(mask))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5)

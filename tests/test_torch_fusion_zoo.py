"""The port's fusion zoo (``models/fusion/{zoo,convgru,graph_fusion}.py``)
against the JAX package's modules, on the CPU in f32.

The padded layout of ``tests/test_fusion_zoo.py``: B 2, max_cav 3 with 3
and 2 live agents (the second sample's last row is padding and zero), C 8,
a 16 x 16 BEV, random pairwise rotations of up to 0.3 rad and translations
of up to 1 pixel at resolution 0.4 and downsample 8.  The same numpy
inputs and weights (``utils/weights.py:load_jax_variables``) go to both
sides.  Tolerance: 1e-5 abs / 1e-5 rel for the parameter-free and one-layer
modules; 1e-4 abs / 1e-4 rel for the transformer and the graph fusions
(stacked layers, sums in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.models.fusion import convgru as jgru
from cobevt_tpu.models.fusion import graph_fusion as jgraph
from cobevt_tpu.models.fusion import zoo as jzoo
from cobevt_tpu_torch.models.fusion import convgru as pgru
from cobevt_tpu_torch.models.fusion import graph_fusion as pgraph
from cobevt_tpu_torch.models.fusion import zoo as pzoo
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

B, L, C, H, W = 2, 3, 8, 16, 16
EXACT = dict(atol=1e-5, rtol=1e-5)
STACKED = dict(atol=1e-4, rtol=1e-4)


def padded(seed=0):
    """(x, agent_mask): x (B, L, H, W, C) with the padded row zeroed."""
    rng = np.random.RandomState(seed)
    mask = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    x = rng.randn(B, L, H, W, C).astype(np.float32)
    return x * mask[:, :, None, None, None], mask


def pairwise_mats(seed=1):
    """(B, L, L, 4, 4) agent j -> agent i transforms at [b, j, i]."""
    rng = np.random.RandomState(seed)
    mats = np.tile(np.eye(4, dtype=np.float32), (B, L, L, 1, 1))
    for b in range(B):
        for j in range(L):
            for i in range(L):
                if i != j:
                    a = rng.uniform(-0.3, 0.3)
                    mats[b, j, i, :2, :2] = [[np.cos(a), -np.sin(a)],
                                             [np.sin(a), np.cos(a)]]
                    mats[b, j, i, :2, 3] = rng.uniform(-3.2, 3.2, 2)
    return mats


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_max_fusion(masked):
    x, mask = padded()
    # a region where the zero padding row wins
    x[:, :, :4] -= 5.0 * mask[:, :, None, None, None]
    want = jzoo.max_fusion(jnp.asarray(x),
                           jnp.asarray(mask) if masked else None)
    got = pzoo.max_fusion(t(x), t(mask) if masked else None)
    assert_close(got, want, **EXACT)
    # without the mask the padded zeros take part, with it they do not
    assert (got[1, :4] == 0).all() != masked


@pytest.mark.parametrize("masked", [False, True])
def test_att_fusion(masked):
    x, mask = padded(2)
    jm = jzoo.AttFusion(C)
    args = (jnp.asarray(x), jnp.asarray(mask) if masked else None)
    want = jm.apply({}, *args)
    got = pzoo.AttFusion(C)(t(x), t(mask) if masked else None)
    assert_close(got, want, **EXACT)


def test_split_attn():
    rng = np.random.RandomState(3)
    windows = [rng.randn(B, L, H, W, C).astype(np.float32) for _ in range(3)]
    jm = jzoo.SplitAttn(C)
    jw = [jnp.asarray(w) for w in windows]
    variables = jax_variables(jm, jw, seed=4)
    want = jax_apply(jm, variables, jw)
    got = port_from(pzoo.SplitAttn(C), variables)([t(w) for w in windows])
    assert_close(got, want, **EXACT)


def test_base_transformer_with_a_padded_agent():
    x, mask = padded(5)
    # a spatial key mask (B, H, W, 1, L): the agent mask, and one neighbour
    # out of range over a band of rows
    spatial = np.broadcast_to(mask[:, None, None, None, :],
                              (B, H, W, 1, L)).copy()
    spatial[0, :5, :, 0, 2] = 0.0
    jm = jzoo.BaseTransformer(C, depth=2, heads=2, dim_head=4, mlp_dim=16)
    args = (jnp.asarray(x), jnp.asarray(spatial), False)
    variables = jax_variables(jm, *args, seed=6)
    want = jax_apply(jm, variables, *args)
    port = port_from(pzoo.BaseTransformer(C, depth=2, heads=2, dim_head=4,
                                          mlp_dim=16), variables)
    with torch.no_grad():
        got = port(t(x), t(spatial))
    assert_close(got, want, **STACKED)


def test_conv_gru_two_layers():
    rng = np.random.RandomState(7)
    x = rng.randn(B, H, W, 2 * C).astype(np.float32)
    jm = jgru.ConvGRU((C, 12))
    variables = jax_variables(jm, jnp.asarray(x), seed=8)
    want = jax_apply(jm, variables, x)
    port = port_from(pgru.ConvGRU(2 * C, (C, 12)), variables)
    with torch.no_grad():
        assert_close(port(t(x)), want, **STACKED)


@pytest.mark.parametrize("gru", [True, False])
@pytest.mark.parametrize("agg", ["avg", "max"])
def test_v2vnet_fusion(gru, agg):
    x, mask = padded(9)
    mats = pairwise_mats(10)
    kw = dict(num_iteration=2, gru_flag=gru, agg_operator=agg,
              discrete_ratio=0.4, downsample_rate=8)
    jm = jgraph.V2VNetFusion(C, **kw)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mats), False)
    variables = jax_variables(jm, *args, seed=11)
    want = jax_apply(jm, variables, *args)
    port = port_from(pgraph.V2VNetFusion(C, **kw), variables)
    with torch.no_grad():
        got = port(t(x), t(mask), t(mats))
    assert_close(got, want, **STACKED)


@pytest.mark.parametrize("use_mask", [True, False])
def test_disconet_fusion(use_mask):
    x, mask = padded(12)
    mats = pairwise_mats(13)
    kw = dict(num_iteration=2, use_mask=use_mask, discrete_ratio=0.4,
              downsample_rate=8)
    jm = jgraph.DiscoNetFusion(C, **kw)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mats), False)
    variables = jax_variables(jm, *args, seed=14)
    want = jax_apply(jm, variables, *args)
    port = port_from(pgraph.DiscoNetFusion(C, **kw), variables)
    with torch.no_grad():
        got = port(t(x), t(mask), t(mats))
    assert_close(got, want, **STACKED)


def test_pairwise_geometry_and_the_square_bev_rule():
    mats = pairwise_mats(15)
    M = jgraph.discretize_transformation(jnp.asarray(mats), 0.4, 8)
    pm = pgraph.discretize_transformation(t(mats), 0.4, 8)
    assert_close(pgraph._pairwise_roi(pm, (H, W)),
                 jgraph._pairwise_roi(M, (H, W)), atol=0, rtol=0)
    x, _ = padded(16)
    y = jgraph.to_flipped(jnp.asarray(x))
    assert_close(pgraph.to_flipped(t(x)), y, atol=0, rtol=0)
    assert_close(pgraph.from_flipped(pgraph.to_flipped(t(x))), x, atol=0,
                 rtol=0)
    assert_close(pgraph._pairwise_warp_flipped(pgraph.to_flipped(t(x)), pm),
                 jgraph._pairwise_warp_flipped(y, M), **EXACT)
    with pytest.raises(ValueError, match="square BEV"):
        pgraph.V2VNetFusion(C)(t(x[:, :, :8]), t(np.ones((B, L), np.float32)),
                               t(mats))

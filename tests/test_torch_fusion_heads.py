"""Port FuseBEVT and heads against the JAX package's stock path.

The JAX side runs with COBEVT_FUSED_FUSION=0.  Same numpy weights and
inputs on both sides, f32 on the CPU.  Tolerance 1e-4 abs / 1e-4 rel
(LayerNorm + softmax over small widths, summed in another order); the
bias expansion is exact up to 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models import heads as jh
from cobevt_tpu.models.fusion import swap_fusion as js
from cobevt_tpu_torch.models import heads as ph
from cobevt_tpu_torch.models.fusion import swap_fusion as ps
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def stock_jax_path(monkeypatch):
    monkeypatch.setenv("COBEVT_FUSED_XATTN", "0")
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "0")


@pytest.mark.parametrize("l", [4, 2])    # full table, and fewer agents
def test_expand_bias_flat_matches_jax_and_gather(l):
    agent_size, w = 4, 3
    heads = 2
    size = (2 * agent_size - 1) * (2 * w - 1) ** 2
    table = np.random.RandomState(0).randn(size, heads).astype(np.float32)
    got = ps.expand_bias_flat(torch.from_numpy(table), agent_size, w, l, w, w)
    assert_close(got, js.expand_bias_flat(jnp.asarray(table), agent_size, w,
                                          l, w, w), atol=1e-6, rtol=1e-6)
    # the same table read through the reference's (T, T) index gather
    idx = js.rel_pos_indices_3d(agent_size, w, w, l)
    T = l * w * w
    gather = table[idx].transpose(0, 2, 1).reshape(T, heads * T)
    np.testing.assert_allclose(got.numpy(), gather, atol=1e-6)


def _fusion_inputs(rng, B=1, L=3, H=8, W=8, d=32):
    x = rng.randn(B, L, H, W, d).astype(np.float32)
    mask = (rng.rand(B, L, H, W) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[:, -1] = 0.0                   # a padded agent
    agent_mask = np.array([[1.0] * (L - 1) + [0.0]], np.float32)
    return x, mask, agent_mask


@pytest.mark.parametrize("mean_over_valid", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_swap_fusion_encoder(mean_over_valid, masked):
    rng = np.random.RandomState(1)
    x, mask, agent_mask = _fusion_inputs(rng)
    kw = dict(input_dim=32, mlp_dim=48, agent_size=3, window_size=4,
              dim_head=16, dropout=0.0, depth=2, mask=masked,
              mean_over_valid=mean_over_valid)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs, agent_mask=jnp.asarray(agent_mask))
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask),
                   agent_mask=torch.from_numpy(agent_mask))
    want = jax_apply(jm, v, *jargs, agent_mask=jnp.asarray(agent_mask))
    assert got.shape == (1, 8, 8, 32)
    assert_close(got, want, **TOL)


def test_feed_forward():
    t = np.random.RandomState(2).randn(3, 5, 32).astype(np.float32)
    jm = js.FeedForward(32, 48)
    v = jax_variables(jm, jnp.asarray(t))
    port = port_from(ps.FeedForward(32, 48), v)
    with torch.no_grad():
        got = port(torch.from_numpy(t))
    assert_close(got, jax_apply(jm, v, jnp.asarray(t)), atol=1e-5, rtol=1e-5)


def test_naive_decoder_and_seg_head():
    x = np.random.RandomState(3).randn(1, 1, 4, 4, 32).astype(np.float32)
    jd = jh.NaiveDecoder(32, 3, (8, 12, 16))
    vd = jax_variables(jd, jnp.asarray(x), False)
    pd = port_from(ph.NaiveDecoder(32, 3, (8, 12, 16)), vd)
    with torch.no_grad():
        y = pd(torch.from_numpy(x))
    jy = jax_apply(jd, vd, jnp.asarray(x), False)
    assert y.shape == (1, 1, 32, 32, 8)
    assert_close(y, jy, **TOL)
    for target in ("dynamic", "static"):
        jsh = jh.BevSegHead(target, 8, 3)
        vs = jax_variables(jsh, jy)
        psh = port_from(ph.BevSegHead(target, 8, 3), vs)
        with torch.no_grad():
            got = psh(y)
        assert_close(got, jax_apply(jsh, vs, jy), **TOL)


def test_naive_compressor():
    x = np.random.RandomState(4).randn(2, 8, 8, 32).astype(np.float32)
    jm = jh.NaiveCompressor(32, 4)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(ph.NaiveCompressor(32, 4), v)
    assert port.encoder[1].eps == 1e-3
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, jax_apply(jm, v, jnp.asarray(x), False), **TOL)

"""Port FAX modules against the JAX package's stock path.

The JAX side runs with COBEVT_FUSED_XATTN=0 (no fused cross-view stage,
the configuration the port mirrors).  Same numpy weights and inputs on
both sides, f32 on the CPU.  Tolerance 1e-4 abs / 1e-4 rel: LayerNorms and
softmaxes over small widths, summed in another order.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models import fax as jf
from cobevt_tpu_torch.models import fax as pf
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


def _run_port(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                        else a for a in args))


def test_grid_helpers_match_jax():
    np.testing.assert_array_equal(pf.bev_world_grid(64, 64, 100., 100., 0., 2),
                                  jf.bev_world_grid(64, 64, 100., 100., 0., 2))
    np.testing.assert_array_equal(pf.image_plane_grid(8, 12, 64, 96),
                                  jf.image_plane_grid(8, 12, 64, 96))
    np.testing.assert_array_equal(pf.rel_pos_indices_2d(4),
                                  jf.rel_pos_indices_2d(4))
    x = np.random.RandomState(0).randn(2, 3, 8, 12, 5).astype(np.float32)
    for p_fn, j_fn in ((pf.window_partition, jf.window_partition),
                       (pf.grid_partition, jf.grid_partition)):
        got = p_fn(torch.from_numpy(x), 4, 3)
        assert_close(got, j_fn(jnp.asarray(x), 4, 3), atol=0, rtol=0)
    assert_close(pf.window_reverse(pf.window_partition(torch.from_numpy(x),
                                                       4, 3)), x, atol=0,
                 rtol=0)
    assert_close(pf.grid_reverse(pf.grid_partition(torch.from_numpy(x), 4, 3)),
                 x, atol=0, rtol=0)
    assert_close(pf.pad_divisible(torch.from_numpy(x), 3, 5),
                 jf.pad_divisible(jnp.asarray(x), 3, 5), atol=0, rtol=0)


def test_bev_embedding():
    args = (32, 1.0, 64, 64, 100.0, 100.0, 0.0, (2, 4, 8))
    jm = jf.BEVEmbedding(*args)
    v = jax_variables(jm)
    port = port_from(pf.BEVEmbedding(*args), v)
    assert_close(_run_port(port), jm.apply(v), atol=0, rtol=0)
    np.testing.assert_array_equal(port.world_grid(1, "cpu").numpy(),
                                  np.asarray(jm.bind(v).world_grid(1)))


def test_self_attention():
    x = np.random.RandomState(1).randn(2, 4, 4, 32).astype(np.float32)
    jm = jf.SelfAttention(32, 16, 0.0, window_size=4)
    v = jax_variables(jm, jnp.asarray(x))
    port = port_from(pf.SelfAttention(32, 16, 0.0, window_size=4), v)
    assert_close(_run_port(port, x), jax_apply(jm, v, jnp.asarray(x)), **TOL)


def test_self_attention_train_dropout_reaches_the_kernel(monkeypatch):
    """In training, attention dropout rides K1 as post-softmax weights
    keep / (1 - p) in q's dtype, one per (token, head, key)."""
    seen = {}

    def spy(q, k, v, n_heads, bias_flat=None, mask=None, weight=None):
        seen["weight"] = weight
        return q

    monkeypatch.setattr(pf, "fused_window_attention_packed", spy)
    port = pf.SelfAttention(32, 16, 0.25, window_size=4).train()
    torch.manual_seed(0)
    port(torch.randn(2, 4, 4, 32))
    w = seen["weight"]
    assert w.shape == (2, 16, 2 * 16) and w.dtype == torch.float32
    assert torch.unique(w).tolist() == [0.0, pytest.approx(1 / 0.75)]
    assert 0.15 < float((w == 0).float().mean()) < 0.35
    port.eval()
    port(torch.randn(2, 4, 4, 32))
    assert seen["weight"] is None


def test_cross_win_attention():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 3, 2, 2, 4, 4, 32).astype(np.float32)
    k = rng.randn(2, 3, 2, 2, 2, 2, 32).astype(np.float32)
    v_ = rng.randn(2, 3, 2, 2, 2, 2, 32).astype(np.float32)
    skip = rng.randn(2, 2, 2, 4, 4, 32).astype(np.float32)
    jm = jf.CrossWinAttention(32, 2, 16, True)
    jargs = [jnp.asarray(a) for a in (q, k, v_, skip)]
    v = jax_variables(jm, *jargs)
    port = port_from(pf.CrossWinAttention(32, 2, 16, True), v)
    assert_close(_run_port(port, q, k, v_, skip), jax_apply(jm, v, *jargs),
                 **TOL)


def _camera_inputs(rng, b, n):
    intr = np.zeros((b, n, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2] = intr[..., 1, 2] = 32.0
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (b, n, 1, 1))
    extr[..., :3, 3] = rng.randn(b, n, 3) * 0.5
    return np.linalg.inv(intr).astype(np.float32), extr


@pytest.mark.parametrize("bev_embed_flag", [True, False])
def test_cross_view_swap_attention(bev_embed_flag):
    rng = np.random.RandomState(3)
    b, n = 2, 2
    x = rng.randn(b, 16, 16, 32).astype(np.float32)
    feat = rng.randn(b, n, 8, 8, 24).astype(np.float32)
    I_inv, E_inv = _camera_inputs(rng, b, n)
    world = jf.bev_world_grid(64, 64, 100.0, 100.0, 0.0, 4) \
        if bev_embed_flag else None
    args = (8, 8, 24, 32, 64, 64, True, 2, 16, (8, 8), (4, 4),
            bev_embed_flag)
    jm = jf.CrossViewSwapAttention(*args)
    jargs = [None if a is None else jnp.asarray(a)
             for a in (x, world, feat, I_inv, E_inv)]
    v = jax_variables(jm, *jargs, False)
    port = port_from(pf.CrossViewSwapAttention(*args), v)
    got = _run_port(port, x, None if world is None else world, feat, I_inv,
                    E_inv)
    assert_close(got, jax_apply(jm, v, *jargs, False), **TOL)


def small_fax_config():
    return jf.FAXConfig(
        dim=(32, 32, 32), middle=(1, 1, 1),
        backbone_output_shape=((16, 16, 128), (8, 8, 256), (4, 4, 512)),
        image_height=64, image_width=64, qkv_bias=True,
        heads=(2, 2, 2), dim_head=(16, 16, 16),
        q_win_size=((8, 8), (8, 8), (8, 8)),
        feat_win_size=((4, 4), (4, 4), (4, 4)),
        bev_embedding_flag=(True, False, False),
        bev_height=64, bev_width=64, upsample_scales=(2, 4, 8),
        self_attn_dim_head=16, self_attn_dropout=0.0, self_attn_window=8)


def test_fax_module():
    rng = np.random.RandomState(4)
    cfg = small_fax_config()
    b, l, n = 1, 2, 2
    feats = [rng.randn(b, l, n, h, w, c).astype(np.float32)
             for h, w, c in cfg.backbone_output_shape]
    I_inv, E_inv = _camera_inputs(rng, b * l, n)
    intr = np.linalg.inv(I_inv).reshape(b, l, n, 3, 3).astype(np.float32)
    extr = E_inv.reshape(b, l, n, 4, 4)
    jm = jf.FAXModule(cfg)
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(intr),
             jnp.asarray(extr))
    v = jax_variables(jm, *jargs, False)
    port = port_from(pf.FAXModule(pf.FAXConfig(**dataclasses.asdict(cfg))),
                     v)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats],
                   torch.from_numpy(intr), torch.from_numpy(extr))
    want = jax_apply(jm, v, *jargs, False)
    assert got.shape == (b, l, 8, 8, 32)
    assert_close(got, want, **TOL)

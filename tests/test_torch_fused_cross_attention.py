"""K2, the fused cross-view branch, against the JAX package.

The port's plain version (what CPU tensors run) against the JAX function
with its Pallas body in interpret mode and against its XLA composite, at
the sizes of tests/test_fused_cross_attention.py and at SinBEVT-nuScenes'
stage 0 widths (D 32, 6 cameras as query segments); then the FAX stage
module with the fused dispatch against the JAX module with default
switches, and both at COBEVT_FUSED_XATTN=0.  Same numpy inputs and
weights on both sides, f32 on the CPU.  Tolerance 1e-4 abs / 1e-4 rel:
LayerNorms, projections and softmaxes summed in another order (the JAX
package's own kernel-vs-composite test holds 2e-5).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models import fax as jf
from cobevt_tpu.ops import fused_cross_attention as jk
from cobevt_tpu_torch.models import fax as pf
from cobevt_tpu_torch.ops import fused_cross_attention as pk
from tests.test_torch_fax import _camera_inputs
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
    torch_tree,
)

TOL = dict(atol=1e-4, rtol=1e-4)
Q_WIN, K_WIN, HEADS = (8, 8), (4, 4), 4
SCALE = 32.0 ** -0.5


def _inputs(B=2, n=4, H=32, W=32, D=128, C=128, h=16, w=16, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def ln():
        return ((rng.rand(D) + 0.5).astype(np.float32), arr(D, scale=0.1))

    data = dict(x=arr(B, H, W, D), wemb=arr(H, W, D), cemb=arr(B, n, D),
                key=arr(B, n, h, w, D), val=arr(B, n, h, w, D))
    params = dict(ln_q=ln(), ln_k=ln(), ln_v=ln(),
                  wq=arr(D, C, scale=0.05), bq=arr(C, scale=0.1),
                  wk=arr(D, C, scale=0.05), bk=arr(C, scale=0.1),
                  wv=arr(D, C, scale=0.05), bv=arr(C, scale=0.1),
                  wo=arr(C, D, scale=0.05), bo=arr(D, scale=0.1))
    mlp = {"ln": ln(), "w1": arr(D, 2 * D, scale=0.05),
           "b1": arr(2 * D, scale=0.1), "w2": arr(2 * D, D, scale=0.05),
           "b2": arr(D, scale=0.1)}
    return data, params, mlp, ln()


def _args(data, params, embed, jax_side):
    conv = (lambda a: jnp.asarray(a)) if jax_side else torch.from_numpy
    tree = (lambda t: {k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                       else jnp.asarray(v) for k, v in t.items()}) \
        if jax_side else torch_tree
    return (conv(data["x"]), conv(data["wemb"]) if embed else None,
            conv(data["cemb"]) if embed else None, conv(data["key"]),
            conv(data["val"]), tree(params))


def _jax_tail(mlp, post_ln, tail):
    if not tail:
        return None, None
    return ({k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
             else jnp.asarray(v) for k, v in mlp.items()},
            tuple(map(jnp.asarray, post_ln)))


@pytest.mark.parametrize("embed", [True, False])
@pytest.mark.parametrize("add_skip", [True, False])
@pytest.mark.parametrize("tail", [False, True])
def test_plain_matches_pallas_body_and_composite(embed, add_skip, tail):
    data, params, mlp, post_ln = _inputs()
    j_mlp, j_post = _jax_tail(mlp, post_ln, tail)
    jargs = _args(data, params, embed, True)
    body = jk.fused_cross_view_attention(
        *jargs, Q_WIN, K_WIN, HEADS, SCALE, add_skip, mlp=j_mlp,
        post_ln=j_post, interpret=True)
    composite = jk._xla_composite(*jargs, Q_WIN, K_WIN, HEADS, SCALE,
                                  add_skip, jnp.float32, j_mlp, j_post)
    got = pk.cross_view_attention_reference(
        *_args(data, params, embed, False), Q_WIN, K_WIN, HEADS, SCALE,
        add_skip, mlp=torch_tree(mlp) if tail else None,
        post_ln=torch_tree(post_ln) if tail else None)
    assert got.shape == (2, 32, 32, 128) and got.dtype == torch.float32
    assert_close(got, body, **TOL)
    assert_close(got, composite, **TOL)


@pytest.mark.parametrize("tail", [False, True])
def test_plain_matches_pallas_body_at_a_nuscenes_stage0_branch(tail):
    """SinBEVT-nuScenes' stage 0 widths (D = C = 32, one head of 32, MLP
    hidden 64, 10 x 10 query windows over 6 cameras' 6 x 12 key windows,
    six query segments from the camera embeddings) at a 2 x 2 window map."""
    q_win, k_win, heads = (10, 10), (6, 12), 1
    data, params, mlp, post_ln = _inputs(B=1, n=6, H=20, W=20, D=32, C=32,
                                         h=12, w=24, seed=3)
    j_mlp, j_post = _jax_tail(mlp, post_ln, tail)
    jargs = _args(data, params, True, True)
    body = jk.fused_cross_view_attention(
        *jargs, q_win, k_win, heads, SCALE, True, mlp=j_mlp, post_ln=j_post,
        interpret=True)
    got = pk.cross_view_attention_reference(
        *_args(data, params, True, False), q_win, k_win, heads, SCALE, True,
        mlp=torch_tree(mlp) if tail else None,
        post_ln=torch_tree(post_ln) if tail else None)
    assert got.shape == (1, 20, 20, 32)
    assert_close(got, body, **TOL)


def test_grid_keys_match_the_factor_swapped_layout():
    """grid_keys=True on the natural key layout equals the JAX call on the
    factor-swapped key and value (models/fax.py:493-498)."""
    from einops import rearrange
    data, params, mlp, post_ln = _inputs(seed=1)
    swap = "b n (p q) (r s) d -> b n (q p) (s r) d"
    jargs = list(_args(data, params, False, True))
    for i in (3, 4):
        jargs[i] = rearrange(jargs[i], swap, p=K_WIN[0], r=K_WIN[1])
    j_mlp, j_post = _jax_tail(mlp, post_ln, True)
    want = jk._xla_composite(*jargs, Q_WIN, K_WIN, HEADS, SCALE, True,
                             jnp.float32, j_mlp, j_post)
    got = pk.fused_cross_view_attention(
        *_args(data, params, False, False), Q_WIN, K_WIN, HEADS, SCALE,
        True, mlp=torch_tree(mlp), post_ln=torch_tree(post_ln),
        grid_keys=True)
    assert_close(got, want, **TOL)


def test_wrapper_runs_the_plain_version_on_cpu_and_refuses_the_kernel():
    data, params, _, _ = _inputs(B=1, H=16, W=16, h=8, w=8, seed=2)
    args = _args(data, params, True, False)
    before = pk.fused_cross_view_attention.launches
    got = pk.fused_cross_view_attention(*args, Q_WIN, K_WIN, HEADS, SCALE)
    want = pk.cross_view_attention_reference(*args, Q_WIN, K_WIN, HEADS,
                                             SCALE)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert pk.fused_cross_view_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        pk.fused_cross_view_attention(*args, Q_WIN, K_WIN, HEADS, SCALE,
                                      impl="kernel")


@pytest.mark.parametrize("shape,ok", [
    ((128, 128, 4, 256, 256), True),     # CorpBEVT stages
    ((32, 32, 2, 32, 64), True),         # head dim 16
    ((32, 32, 4, 32, 64), True),         # head dim 8
    ((128, 128, 2, 256, 256), False),    # head dim 64
    ((40, 40, 4, 256, 80), False),       # width not a multiple of 16
    ((128, 128, 4, 252, 256), False),    # keys not a multiple of 8
    ((512, 512, 16, 256, 1024), False),  # row tiles over the shared memory
])
def test_kernel_accepts(shape, ok):
    assert pk.kernel_accepts(*shape) is ok


def _spy(monkeypatch):
    calls = []
    real = pf.fused_cross_view_attention

    def spy(*args, **kwargs):
        calls.append(kwargs.get("grid_keys", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(pf, "fused_cross_view_attention", spy)
    return calls


@pytest.mark.parametrize("switch", [None, "0"])
@pytest.mark.parametrize("bev_embed_flag", [True, False])
def test_stage_dispatch_matches_jax(monkeypatch, switch, bev_embed_flag):
    """Default switches: the port takes K2 for both branches (the spy sees
    the local and the grid call) and matches the JAX stage, whose fused
    branches run their composite on the CPU.  COBEVT_FUSED_XATTN=0: both
    sides run the stock modules and K2 is not called."""
    if switch is None:
        monkeypatch.delenv("COBEVT_FUSED_XATTN", raising=False)
    else:
        monkeypatch.setenv("COBEVT_FUSED_XATTN", switch)
    calls = _spy(monkeypatch)
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
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   None if world is None else torch.from_numpy(world),
                   torch.from_numpy(feat), torch.from_numpy(I_inv),
                   torch.from_numpy(E_inv))
    assert_close(got, jax_apply(jm, v, *jargs, False), **TOL)
    assert calls == ([False, True] if switch is None else [])
    # training always runs the stock modules, as in the JAX package
    calls.clear()
    port.train()
    with torch.no_grad():
        port(torch.from_numpy(x),
             None if world is None else torch.from_numpy(world),
             torch.from_numpy(feat), torch.from_numpy(I_inv),
             torch.from_numpy(E_inv))
    assert calls == []


def test_stage_repacks_after_an_in_place_weight_update():
    """The stage packs K2's operands once; an in-place update of a weight
    (as load_state_dict makes) must reach the next forward."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 16, 16, 32).astype(np.float32))
    feat = torch.from_numpy(rng.randn(1, 2, 8, 8, 24).astype(np.float32))
    I_inv, E_inv = (torch.from_numpy(a) for a in _camera_inputs(rng, 1, 2))
    port = pf.CrossViewSwapAttention(8, 8, 24, 32, 64, 64, True, 2, 16,
                                     (8, 8), (4, 4), False).eval()
    with torch.no_grad():
        before = port(x, None, feat, I_inv, E_inv)
        again = port(x, None, feat, I_inv, E_inv)
        port.postnorm.bias.add_(0.5)      # the last op of the grid branch
        after = port(x, None, feat, I_inv, E_inv)
    torch.testing.assert_close(again, before, atol=0, rtol=0)
    torch.testing.assert_close(after, before + 0.5, atol=1e-5, rtol=1e-5)

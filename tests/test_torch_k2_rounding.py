"""K2's plain version rounds in bf16 where the JAX Pallas body rounds.

The body (``cobevt_tpu/ops/fused_cross_attention.py:_kernel``) adds the
output projection's bias and the skip on the f32 accumulator, rounds the
attention probabilities to bf16 before both the numerator and the per-head
sum (``_packed_attn``), and adds the cameras one after another.  The port's
plain version does the same, so in bf16 the two agree bit for bit on most
elements and elsewhere within a few bf16 units of the magnitude of the terms
summed at the skip and the MLP residual (``chip_smoke.py:k2_scale``), the
quantity that phase 3 of ``chip_smoke.py`` holds K2 to.

The JAX side runs its Pallas body in interpret mode, compiled with
``xla_allow_excess_precision`` off: XLA on the CPU otherwise drops the body's
bf16 rounding of the query (``emb.astype(bf16) + x``) and keeps it in f32,
which the TPU body does not do.

Budgets, from the readings at these inputs (bit-equal 0.985-0.997, worst
|port - body| / scale 0.0137): at least 97% of elements bit-equal and every
element within 2^-5 of its scale (eight bf16 units of 2^-8).  The plain
version before this repair, with its probabilities in f32, read 79-94%
bit-equal and up to 0.14 of the scale.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from chip_smoke import k2_scale
from cobevt_tpu.ops import fused_cross_attention as jk
from cobevt_tpu_torch.ops import fused_cross_attention as pk
from tests.test_torch_fused_cross_attention import (
    HEADS,
    K_WIN,
    Q_WIN,
    SCALE,
    _inputs,
)

BIT_EQUAL_SHARE = 0.97
SCALE_BUDGET = 2.0 ** -5


def _jtree(t):
    return {k: tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
            else jnp.asarray(v) for k, v in t.items()}


def _ttree(t):
    return {k: tuple(map(torch.from_numpy, v)) if isinstance(v, tuple)
            else torch.from_numpy(v) for k, v in t.items()}


def _body_bf16(data, params, mlp, post_ln, embed, tail):
    def bf(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    args = (bf(data["x"]), bf(data["wemb"]) if embed else None,
            bf(data["cemb"]) if embed else None, bf(data["key"]),
            bf(data["val"]), _jtree(params),
            _jtree(mlp) if tail else None,
            tuple(map(jnp.asarray, post_ln)) if tail else None)

    def body(x, we, ce, k, v, p, m, pl):
        return jk.fused_cross_view_attention(
            x, we, ce, k, v, p, Q_WIN, K_WIN, HEADS, SCALE, True, mlp=m,
            post_ln=pl, interpret=True)

    compiled = jax.jit(body).lower(*args).compile(
        {"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args).astype(jnp.float32))


def _plain_bf16(data, params, mlp, post_ln, embed, tail):
    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    packed = pk.pack_params(
        _ttree(params), _ttree(mlp) if tail else None,
        tuple(map(torch.from_numpy, post_ln)) if tail else None,
        torch.bfloat16)
    args = (bf(data["x"]), bf(data["wemb"]) if embed else None,
            bf(data["cemb"]) if embed else None, bf(data["key"]),
            bf(data["val"]), packed, Q_WIN, K_WIN, HEADS, SCALE)
    out = pk.cross_view_attention_reference(*args, True)
    mag = k2_scale(*args)
    assert out.dtype == torch.bfloat16 and mag.dtype == torch.float32
    return out.float().numpy(), mag.numpy()


@pytest.mark.parametrize("embed", [True, False])
@pytest.mark.parametrize("tail", [False, True])
def test_bf16_plain_rounds_where_the_pallas_body_rounds(embed, tail):
    data, params, mlp, post_ln = _inputs(B=1, H=16, W=16, h=8, w=8, seed=0)
    want = _body_bf16(data, params, mlp, post_ln, embed, tail)
    got, mag = _plain_bf16(data, params, mlp, post_ln, embed, tail)
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= BIT_EQUAL_SHARE, (diff == 0).mean()
    ratio = diff / np.maximum(mag, np.abs(want))
    assert ratio.max() <= SCALE_BUDGET, ratio.max()


def test_scale_covers_the_terms_of_the_skip_and_the_mlp_residual():
    """The scale is at least |output| and at least |x| where the skip adds
    x; with the MLP it grows by the residual's own magnitude."""
    data, params, mlp, _ = _inputs(B=1, H=16, W=16, h=8, w=8, seed=1)
    def run(mlp_params):
        args = (torch.from_numpy(data["x"]), None, None,
                torch.from_numpy(data["key"]), torch.from_numpy(data["val"]),
                pk.pack_params(_ttree(params), mlp_params), Q_WIN, K_WIN,
                HEADS, SCALE)
        return pk.cross_view_attention_reference(*args, True), k2_scale(*args)

    out, mag = run(None)
    assert torch.all(mag >= out.abs() - 1e-6)
    assert torch.all(mag >= torch.from_numpy(data["x"]).abs() - 1e-6)
    out2, mag2 = run(_ttree(mlp))
    assert torch.all(mag2 >= mag - 1e-6) and torch.all(mag2 >= out2.abs()
                                                       - 1e-5)


def test_f32_probabilities_are_not_rounded():
    """In f32 the rounded core is the softmax itself (the f32 tests of
    ``test_torch_fused_cross_attention.py`` hold the rest)."""
    from cobevt_tpu_torch.ops.window_attention import (
        packed_attention_reference,
    )
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 16, 32, generator=gen) for _ in range(3))
    got = pk.packed_attention_rounded(q, k, v, 2, torch.float32)
    torch.testing.assert_close(got, packed_attention_reference(q, k, v, 2),
                               atol=1e-6, rtol=1e-5)

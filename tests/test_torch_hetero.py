"""V2X-ViT's heterogeneous / temporal agent attention in the port against
the JAX package: the sinusoid tables, ``cav_positional_encoding``,
``RTE`` and ``HGTCavAttention`` with both agent types and a masked agent.

Same numpy weights (through the weight bridge) and inputs on both sides,
f32 on the CPU.  Tolerances: the tables are equal (the same numpy code);
the encodings and the attention 1e-5 abs/rel (single layers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.models.fusion import hetero as jh
from cobevt_tpu_torch.models.fusion import hetero as ph
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scaled", [False, True])
def test_sinusoid_tables_equal(scaled):
    np.testing.assert_array_equal(ph.sinusoid_table(7, 12, scaled),
                                  jh.sinusoid_table(7, 12, scaled))


def test_cav_positional_encoding_matches():
    x = np.random.RandomState(0).randn(2, 3, 4, 5, 16).astype(np.float32)
    want = jh.cav_positional_encoding(jnp.asarray(x))
    got = ph.cav_positional_encoding(torch.from_numpy(x))
    assert_close(got, want, **TOL)


def test_rte_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 5, 16).astype(np.float32)
    # delays past max_len / ratio are clipped to the table's last row
    dts = np.array([[0, 3, 70], [1, 0, 2]], np.int32)
    jm = jh.RTE(16, rte_ratio=2, max_len=100)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(dts))
    port = port_from(ph.RTE(16, rte_ratio=2, max_len=100), v)
    want = jax_apply(jm, v, jnp.asarray(x), jnp.asarray(dts))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(dts))
    assert_close(got, want, **TOL)


def _hgt_inputs(seed=2):
    """3 agents of mixed types (ego 0, then 1, 0) on a 4 x 6 map; agent 2
    masked on every pixel, agent 1 on a few."""
    rng = np.random.RandomState(seed)
    B, L, H, W, C = 1, 3, 4, 6, 32
    x = rng.randn(B, L, H, W, C).astype(np.float32)
    mask = np.ones((B, H, W, L, 1), np.float32)
    mask[..., 2, 0] = 0.0
    mask[0, :2, :3, 1, 0] = 0.0
    prior = np.zeros((B, L, H, W, 3), np.float32)
    prior[:, 1, ..., 2] = 1.0
    prior[..., 1] = rng.randint(0, 3, (B, L, 1, 1))
    return x, mask, prior


@pytest.mark.parametrize("dim_head", [8, 16])
def test_hgt_cav_attention_matches(dim_head):
    x, mask, prior = _hgt_inputs()
    heads = 4
    jm = jh.HGTCavAttention(32, heads, num_types=2, num_relations=4,
                            dim_head=dim_head, dropout=0.1)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(prior))
    v = jax_variables(jm, *args, False, seed=dim_head)
    assert v["params"]["relation_att"].shape == (4, heads, dim_head,
                                                 dim_head)
    port = port_from(ph.HGTCavAttention(32, heads, num_types=2,
                                        num_relations=4, dim_head=dim_head,
                                        dropout=0.1), v)
    want = jax_apply(jm, v, *args, False)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (x, mask, prior)))
    assert got.shape == x.shape
    assert_close(got, want, **TOL)
    # both types' projections matter: swapping an agent's type changes it
    prior2 = prior.copy()
    prior2[:, 1, ..., 2] = 0.0
    with torch.no_grad():
        got2 = port(*(torch.from_numpy(a) for a in (x, mask, prior2)))
    assert np.abs(got2.numpy() - got.numpy()).max() > 1e-2

"""The port's stem-maxpool micro against the JAX tool.

``pool_plain`` (ATen's pool and its backward) against the JAX tool's
``pool_xla`` (select-and-scatter), and the port's ``pool_routed`` against
the JAX tool's ``pool_routed`` (its custom VJP), forward and input gradient
of the tool's loss ``sum(f32(pool(x))^2)``, in f32 at a small shape, on
normals and on tie-heavy integers in [-2, 2].  The JAX tool reads its shape
from module globals at trace time; the test sets them with ``monkeypatch``.
On ties every version routes the gradient to the first tap of the window
in row-major order, so both pairs and the two port versions agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.tools import micro_maxpool_bwd as jtool
from cobevt_tpu_torch.tools import micro_maxpool_bwd as tool

SHAPE = (2, 16, 12, 8)


def _input(kind):
    rng = np.random.RandomState(0)
    if kind == "normal":
        return rng.randn(*SHAPE).astype(np.float32)
    return rng.randint(-2, 3, SHAPE).astype(np.float32)


def _jax_grad(pool, x):
    return np.asarray(jax.grad(
        lambda z: (pool(z).astype(jnp.float32) ** 2).sum())(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_pools_match_the_jax_tool(monkeypatch, kind):
    for name, v in zip("BHWC", SHAPE):
        monkeypatch.setattr(jtool, name, v)
    x = _input(kind)
    tx = torch.from_numpy(x)
    for port, ref in ((tool.pool_plain, jtool.pool_xla),
                      (tool.pool_routed, jtool.pool_routed)):
        assert np.array_equal(port(tx).numpy(), np.asarray(ref(
            jnp.asarray(x))))
        assert np.array_equal(tool.grad(port, tx).numpy(),
                              _jax_grad(ref, x))
    assert torch.equal(tool.grad(tool.pool_plain, tx),
                       tool.grad(tool.pool_routed, tx))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 9, 11, 4)])
def test_routed_pool_takes_its_shape_from_the_input(shape):
    """Odd sizes too, in bf16, and the tool's CPU run."""
    out = tool.run(torch.device("cpu"), shape, iters=0)
    assert out["grad_equal"] and out["forward_equal"]
    assert out["grad_max_abs"] == 0.0 and "plain_ms" not in out

"""Shared helpers for the JAX-vs-port parity tests (tests/test_torch_*.py).

The JAX module's variable tree comes from ``jax.eval_shape`` of its init
(no init computation runs); every leaf is then drawn with numpy from a
seed, BatchNorm running statistics included, so eval-mode BN is a real
test.  ``load_jax_variables`` moves the same values into the port module.
Inputs are numpy arrays handed to both sides.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu_torch.utils.weights import load_jax_variables

torch.set_num_threads(2)


def _draw(rng, name, shape):
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.randn(*shape) / np.sqrt(fan_in)
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name == "bias":
        return 0.1 * rng.randn(*shape)
    if name == "embedding":
        return 0.5 * rng.randn(*shape)
    if name == "mean":
        return 0.5 * rng.randn(*shape)
    if name == "var":
        return rng.rand(*shape) + 0.5
    return rng.randn(*shape)          # learned tensors


def _fill(rng, tree):
    return {k: _fill(rng, v) if isinstance(v, Mapping)
            else _draw(rng, k, v.shape).astype(np.float32)
            for k, v in sorted(tree.items())}


def jax_variables(module, *args, seed: int = 0, **kwargs) -> dict:
    """Random numpy variables of a flax module for the given call."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _fill(np.random.RandomState(seed), shapes)


def jax_apply(module, variables, *args, **kwargs):
    """``module.apply(variables, *args, **kwargs)`` under ``jax.jit`` (one
    compile instead of an eager dispatch per op).  Array arguments are
    traced; bools, strings and None stay static."""
    data_idx = [i for i, a in enumerate(args)
                if isinstance(a, (np.ndarray, jax.Array, list, dict))]

    def fn(v, data):
        full = list(args)
        for i, d in zip(data_idx, data):
            full[i] = d
        return module.apply(v, *full, **kwargs)

    return jax.jit(fn)(variables, [args[i] for i in data_idx])


def port_from(module: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """The port module in eval mode, holding the JAX variables."""
    load_jax_variables(module, variables)
    return module.eval()


def jnp_tree(x):
    return jax.tree.map(jnp.asarray, x)


def torch_tree(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def assert_close(port_out, jax_out, atol, rtol):
    """Compare a port output (tensor or dict of tensors) with the JAX one."""
    if isinstance(jax_out, dict):
        assert set(port_out) == set(jax_out)
        for k in jax_out:
            assert_close(port_out[k], jax_out[k], atol, rtol)
        return
    got = port_out.detach().float().numpy()
    want = np.asarray(jax_out, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def calibrate_bn(port: torch.nn.Module, variables: dict, *args,
                 **kwargs) -> dict:
    """Set every BatchNorm's running statistics of ``port`` to the batch
    statistics of one forward of ``args`` (momentum 1, the other modules
    in eval mode), so a deep net at random weights is not saturated, and
    return the JAX variables holding the same values (the bridge's
    reverse direction).  ``port`` is left in eval mode."""
    from cobevt_tpu.utils.torch_port import (
        fit_to_template,
        state_dict_to_numpy,
        torch_to_flax,
    )
    bns = [m for m in port.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    port.eval()
    for bn in bns:
        bn.momentum = 1.0
        bn.train()
    with torch.no_grad():
        port(*args, **kwargs)
    for bn, momentum in zip(bns, momenta):
        bn.momentum = momentum
    port.eval()
    converted = torch_to_flax(state_dict_to_numpy(port.state_dict()))
    return {col: fit_to_template(converted[col], variables[col])
            for col in variables}

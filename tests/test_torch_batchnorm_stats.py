"""BatchNorm running statistics after a train-mode call, port against flax.

flax's ``nn.BatchNorm`` stores the biased batch variance in
``batch_stats``; PyTorch's ``nn.BatchNorm2d`` updates ``running_var`` with
the unbiased one, a factor n/(n-1) apart.  The port's ``BatchNorm2d``
follows flax, so a model trained by the port has the JAX package's
statistics.  Small shapes, where n/(n-1) shows: 1e-5 abs / 1e-5 rel on the
updated ``running_mean`` / ``running_var`` against flax's mutated
``batch_stats`` (the same f32 means, summed in another order).
"""

import numpy as np
import jax.numpy as jnp
import torch

from cobevt_tpu.nn import layers as jl
from cobevt_tpu.nn.resnet import ResNetEncoder as JaxResNetEncoder
from cobevt_tpu_torch.nn import layers as pl
from cobevt_tpu_torch.nn.resnet import ResNetEncoder
from cobevt_tpu_torch.utils.weights import jax_tree_to_state_dict
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _check_statistics(port, updates, before):
    want = jax_tree_to_state_dict(port, {"batch_stats":
                                         updates["batch_stats"]})
    got = port.state_dict()
    assert want and all("running_" in k for k in want)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)
        moved += not np.allclose(before[k].numpy(), w, **TOL)
    assert moved == len(want)           # every statistic was updated
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1


def test_basic_block_train_mode_stores_flax_statistics():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 3, 16).astype(np.float32) * 2 + 0.5    # n = 18
    jm = jl.BasicBlock(16, 1)
    v = jax_variables(jm, jnp.asarray(x), False)
    want, updates = jax_apply(jm, v, jnp.asarray(x), True,
                              mutable=["batch_stats"])
    port = port_from(pl.BasicBlock(16, 16), v).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    _check_statistics(port, updates, before)
    # the unbiased update of a stock nn.BatchNorm2d is n/(n-1) = 18/17 off
    stock = torch.nn.BatchNorm2d(16, eps=1e-5, momentum=0.1).train()
    stock.load_state_dict(port_from(pl.BasicBlock(16, 16), v).bn1.state_dict())
    y = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        stock(port.conv1(y))
    ours = port.bn1.running_var
    start = before["bn1.running_var"]
    np.testing.assert_allclose(
        ((stock.running_var - 0.9 * start) / (ours - 0.9 * start)).numpy(),
        18 / 17, rtol=1e-4)


def test_resnet18_encoder_train_mode_stores_flax_statistics():
    rng = np.random.RandomState(6)
    x = rng.rand(1, 1, 2, 64, 64, 3).astype(np.float32)
    jm = JaxResNetEncoder(18, (1, 2, 3))
    v = jax_variables(jm, jnp.asarray(x), False)
    want, updates = jax_apply(jm, v, jnp.asarray(x), True,
                              mutable=["batch_stats"])
    port = port_from(ResNetEncoder(18, (1, 2, 3)), v).train()
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert_close(g, w, atol=2e-4, rtol=1e-3)
    _check_statistics(port, updates, before)    # layer4 has n = 8


def test_remat_leaves_statistics_and_gradients_unchanged():
    """``encoder_remat`` recomputes each block in the backward pass; the
    second forward must not count its batch twice."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.rand(1, 1, 2, 32, 32, 3).astype(np.float32))
    plain = ResNetEncoder(18, (1, 2, 3)).train()
    remat = ResNetEncoder(18, (1, 2, 3), remat=True).train()
    remat.load_state_dict(plain.state_dict())
    for m in (plain, remat):
        sum(o.square().mean() for o in m(x)).backward()
    for (k, a), (_, b) in zip(plain.state_dict().items(),
                              remat.state_dict().items()):
        torch.testing.assert_close(a, b, msg=k)
    for (k, a), (_, b) in zip(plain.named_parameters(),
                              remat.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, msg=k)

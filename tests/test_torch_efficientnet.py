"""The ported EfficientNet trunk against the JAX package.

b0 at 64 x 128 with every endpoint (reduction_1 .. reduction_5): the same
numpy weights (BatchNorm running statistics taken from a calibration
batch, so the random net is not saturated) and the same input through the flax module and the
port, f32 on the CPU.  Tolerance 1e-4 abs / 1e-3 rel on every endpoint:
sixteen blocks of products summed in another order stay well inside it.
The trunk's static helpers (block specs, endpoint boundaries, output
shapes) are compared for b0-b4 with no forward.  Also: TF-SAME padding at
odd and even sizes against flax's own, the depthwise weights' layout
through the bridge, the drop-connect gate and its rematerialised forward.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from cobevt_tpu.nn import efficientnet as jeff
from cobevt_tpu.utils.torch_port import (
    fit_to_template,
    state_dict_to_numpy,
    torch_to_flax,
)
from cobevt_tpu_torch.nn import efficientnet as peff
from tests.torch_parity import (
    assert_close,
    calibrate_bn,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-4, rtol=1e-3)
MODELS = ("efficientnet-b0", "efficientnet-b1", "efficientnet-b2",
          "efficientnet-b3", "efficientnet-b4")
B0_LAYERS = ("reduction_1", "reduction_2", "reduction_3", "reduction_4",
             "reduction_5")


@pytest.fixture(scope="module")
def b0():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 64, 128, 3).astype(np.float32)
    jm = jeff.EfficientNetExtractor(B0_LAYERS, "efficientnet-b0")
    v = jax_variables(jm, x, False, seed=1)
    port = port_from(peff.EfficientNetExtractor(B0_LAYERS, "efficientnet-b0"),
                     v)
    # BN statistics from a calibration batch, else the random net saturates
    v = calibrate_bn(port, v, torch.from_numpy(
        rng.rand(4, 64, 128, 3).astype(np.float32)))
    return jm, v, port, x


def test_b0_every_endpoint_matches_jax(b0):
    jm, v, port, x = b0
    want = jax_apply(jm, v, x, False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close(g, w, **TOL)
    assert [tuple(g.shape[1:]) for g in got] == \
        jeff.EfficientNetExtractor.output_shapes(B0_LAYERS, (64, 128),
                                                 "efficientnet-b0")


def test_b0_output_moves_with_its_input(b0):
    """Vacuity guard: random BN statistics keep the net unsaturated, so a
    perturbed input moves the deepest endpoint."""
    _, _, port, x = b0
    rng = np.random.RandomState(2)
    with torch.no_grad():
        a = port(torch.from_numpy(x))[-1]
        b = port(torch.from_numpy(
            x + 0.1 * rng.rand(*x.shape).astype(np.float32)))[-1]
    assert float((a - b).abs().max()) > 0.01


@pytest.mark.parametrize("name", MODELS)
def test_static_helpers_match_jax(name):
    assert peff.block_specs(name) == [
        peff.BlockSpec(**vars(s)) for s in jeff.block_specs(name)]
    assert peff.reduction_boundaries(name) == jeff.reduction_boundaries(name)
    assert peff.round_filters(32, jeff._SCALING[name][0]) == \
        jeff.round_filters(32, jeff._SCALING[name][0])
    names = [n for n, _ in jeff.reduction_boundaries(name)][1:5]
    assert peff.EfficientNetExtractor.output_shapes(
        names, (224, 480), name) == jeff.EfficientNetExtractor.output_shapes(
            names, (224, 480), name)


def test_b4_endpoints_at_the_nuscenes_geometry():
    shapes = peff.EfficientNetExtractor.output_shapes(
        ("reduction_2", "reduction_3", "reduction_4"), (224, 480))
    assert shapes == [(56, 120, 32), (28, 60, 56), (14, 30, 112)]
    assert peff.reduction_boundaries("efficientnet-b4")[:5] == [
        ("reduction_1", (0, 0)), ("reduction_2", (0, 3)),
        ("reduction_3", (3, 7)), ("reduction_4", (7, 11)),
        ("reduction_5", (11, 23))]


@pytest.mark.parametrize("kernel,stride,size", [
    (3, 2, 16), (3, 2, 15), (5, 2, 16), (5, 2, 17), (5, 1, 9), (3, 1, 8)])
def test_same_pad_matches_flax_same(kernel, stride, size):
    """A depthwise conv after same_pad equals flax's padding="SAME" conv,
    depthwise weights carried (k, k, 1, C) -> (C, 1, k, k) by the bridge's
    rule; a symmetric pad would shift the stride-2 taps."""
    rng = np.random.RandomState(kernel * 100 + size)
    C = 8
    x = rng.randn(2, size, size + 3, C).astype(np.float32)
    w = rng.randn(kernel, kernel, 1, C).astype(np.float32)
    conv = fnn.Conv(C, (kernel, kernel), strides=(stride, stride),
                    padding="SAME", feature_group_count=C, use_bias=False)
    want = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    tconv = torch.nn.Conv2d(C, C, kernel, stride, 0, groups=C, bias=False)
    port_from(tconv, {"params": {"kernel": w}})
    with torch.no_grad():
        got = tconv(peff.same_pad(torch.from_numpy(x), kernel, stride)
                    .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bridge_round_trip_gives_the_jax_tree(b0):
    _, v, port, _ = b0
    converted = torch_to_flax(state_dict_to_numpy(port.state_dict()))
    for col in v:
        back = fit_to_template(converted[col], v[col])
        jax.tree.map(np.testing.assert_array_equal, back, v[col])


def _gates(model, n, seed):
    """The drop-connect gates a training forward of ``n`` samples draws
    from a generator seeded ``seed``, replayed in block order."""
    g = torch.Generator().manual_seed(seed)
    x = torch.zeros(n, 1, 1, 1)
    return [gate for group in model.layers[1:] for block in group
            if (gate := block.drop_gate(x, g)) is not None]


def test_drop_connect_and_remat_in_training():
    """Training draws one gate a block from the generator, outside the
    rematerialised block: the remat forward and backward equal the plain
    training ones under the same seed, with some sample dropped; eval
    draws nothing."""
    torch.manual_seed(0)
    layers = ("reduction_5",)
    plain = peff.EfficientNetExtractor(layers, "efficientnet-b0").train()
    remat = peff.EfficientNetExtractor(layers, "efficientnet-b0",
                                       remat=True).train()
    remat.load_state_dict(plain.state_dict())
    n = 8
    x = torch.from_numpy(np.random.RandomState(3).rand(n, 32, 32, 3)
                         .astype(np.float32))
    gates = _gates(plain, n, 7)
    assert any(bool((g == 0).any()) for g in gates)
    # kept samples are scaled by 1 / keep
    assert all(bool(((g == 0) | (g > 1)).all()) for g in gates)
    assert any(not torch.equal(a, b)
               for a, b in zip(gates, _gates(plain, n, 8)))
    outs, grads = [], []
    for model in (plain, remat):
        out = model(x, generator=torch.Generator().manual_seed(7))[0]
        out.square().mean().backward()
        outs.append(out.detach())
        grads.append(model.layers[1][1]._project_conv.weight.grad.clone())
    torch.testing.assert_close(outs[0], outs[1])
    torch.testing.assert_close(grads[0], grads[1])
    assert not torch.equal(outs[0], plain.eval()(x)[0].detach())
    assert _gates(plain, n, 7) == []

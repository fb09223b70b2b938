"""The int8-resident layer1 path of the port against the JAX package.

``cobevt_tpu_torch/ops/int8_chain.py`` against ``cobevt_tpu/ops/int8_chain.py``
on the same numpy inputs: quantized tensors, scales and the int8 outputs of
``conv3x3_s8`` must be EQUAL, f32 outputs within 1e-6 of the largest value
(equal integers; one side may contract a multiply-add), the clipped share
within 1e-6.

``ResNetTrunk`` under ``COBEVT_INT8=1`` against the JAX trunk, f32 at 64^2 with
the JAX variables carried over by ``utils/weights.py``.  The integers cannot
be held equal through a whole trunk: the float convolutions before and
between the int8 regions sum in another order, and a value that lands within
rounding of a tie moves by one quantum (a 127th of the tensor's range), which
the later stages spread (measured here: the largest deviation is 1.0e-4 of
a stage's largest value, and 0.012% of one stage's elements pass 1e-4).  So
every stage must agree within 5e-3 of its largest value everywhere (the
quantization drift itself is percents), and at most 0.1% of a stage's
elements may differ by more than 1e-4 of it.  With the flag
off, and layer1 under ``COBEVT_INT8_RESIDENT=0``, the port is bitwise its
stock path.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.nn.resnet import ResNetTrunk as JaxTrunk
from cobevt_tpu.ops import int8_chain as jax_chain
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn import layers as port_layers
from cobevt_tpu_torch.nn.resnet import ResNetTrunk
from cobevt_tpu_torch.ops import int8_chain as port_chain
from cobevt_tpu_torch.ops.int8_chain import (
    BLOCK_GROWTH,
    INTERMEDIATE_HEADROOM,
    conv3x3_s8,
    pack_s8_weight,
    quantize_dynamic,
    quantize_kernel_per_out,
)
from tests.torch_parity import jax_variables, port_from


def test_schedule_constants_are_the_jax_package_s():
    assert INTERMEDIATE_HEADROOM == jax_chain.INTERMEDIATE_HEADROOM == 2.0
    assert BLOCK_GROWTH == jax_chain.BLOCK_GROWTH == 1.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dynamic_equals_jax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 9, 7, 64) * 3).astype(np.float32)
    xq, s = quantize_dynamic(torch.from_numpy(x).to(getattr(torch, dtype)))
    jq, js = jax_chain.quantize_dynamic(jnp.asarray(x, dtype))
    assert xq.dtype == torch.int8 and s.dtype == torch.float32
    assert s.dim() == 0 and s.item() == float(js)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    zq, zs = quantize_dynamic(torch.zeros(3, 4))
    assert zs.item() == np.float32(1e-12) and not zq.any()


def test_quantize_kernel_per_out_equals_jax():
    rng = np.random.RandomState(1)
    w = (rng.randn(3, 3, 64, 64) * 0.1).astype(np.float32)
    w[..., 7] = 0.0
    wq, sw = quantize_kernel_per_out(torch.from_numpy(w))
    jq, js = jax_chain.quantize_kernel_per_out(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(js))
    packed = pack_s8_weight(torch.from_numpy(w), torch.zeros(64))
    assert torch.equal(packed.w_q, wq) and torch.equal(packed.s_w, sw)
    assert torch.equal(packed.wt[9].reshape(3, 3, 64), wq[..., 9])


def _chain_data(seed, C=64, O=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, C).astype(np.float32)
    res = np.abs(rng.randn(2, 8, 8, O)).astype(np.float32)
    w = (rng.randn(3, 3, C, O) * 0.1).astype(np.float32)
    t = (rng.randn(O) * 0.05).astype(np.float32)
    return x, res, w, t


@pytest.mark.parametrize("case", ["interior", "interior_saturating",
                                  "interior_residual", "exit_f32",
                                  "exit_bf16_residual", "no_relu"])
def test_conv3x3_s8_equals_jax(case):
    x, res, w, t = _chain_data(2)
    jq, js = jax_chain.quantize_dynamic(jnp.asarray(x))
    jrq, jrs = jax_chain.quantize_dynamic(jnp.asarray(res))
    jwq, jsw = jax_chain.quantize_kernel_per_out(jnp.asarray(w))
    xq, sx = quantize_dynamic(torch.from_numpy(x))
    rq, rs = quantize_dynamic(torch.from_numpy(res))
    wq, sw = quantize_kernel_per_out(torch.from_numpy(w))
    kwargs = {
        "interior": dict(out_scale=0.05),
        # a scale far below the range: nearly half the values clip
        "interior_saturating": dict(out_scale=0.002),
        "interior_residual": dict(out_scale=0.05, residual=True),
        "exit_f32": dict(out_dtype="float32"),
        "exit_bf16_residual": dict(out_dtype="bfloat16", residual=True),
        "no_relu": dict(out_scale=0.05, relu=False),
    }[case]
    residual = kwargs.pop("residual", False)
    out_dtype = kwargs.pop("out_dtype", "bfloat16")
    got, sat = conv3x3_s8(
        xq, sx, wq, sw, torch.from_numpy(t), with_sat=True,
        residual_q=rq if residual else None,
        residual_scale=rs if residual else None,
        out_dtype=getattr(torch, out_dtype), **kwargs)
    want, jsat = jax_chain.conv3x3_s8(
        jq, js, jwq, jsw, jnp.asarray(t), with_sat=True,
        residual_q=jrq if residual else None,
        residual_scale=jrs if residual else None,
        out_dtype=getattr(jnp, out_dtype), **kwargs)
    assert abs(sat.item() - float(jsat)) <= 1e-6
    if "out_scale" in kwargs:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (sat.item() > 0.2) == (case == "interior_saturating")
    else:
        assert got.dtype == getattr(torch, out_dtype) and sat.item() == 0.0
        want = np.asarray(want.astype(jnp.float32))
        tol = 1e-6 * np.abs(want).max()
        if out_dtype == "bfloat16":
            tol = tol + 2.0 ** -7 * np.abs(want)       # one bf16 ulp
        assert (np.abs(got.float().numpy() - want) <= tol).all()
    # without the clipped share the output comes alone
    alone = conv3x3_s8(xq, sx, wq, sw, torch.from_numpy(t),
                       residual_q=rq if residual else None,
                       residual_scale=rs if residual else None,
                       out_dtype=getattr(torch, out_dtype), **kwargs)
    assert torch.equal(alone, got)


def test_conv3x3_s8_on_the_cpu_runs_the_plain_version():
    x, _, w, t = _chain_data(3)
    xq, sx = quantize_dynamic(torch.from_numpy(x))
    wq, sw = quantize_kernel_per_out(torch.from_numpy(w))
    ops.reset_launch_counts()
    conv3x3_s8(xq, sx, wq, sw, torch.from_numpy(t), out_scale=0.05)
    assert ops.launch_counts()["conv3x3_s8"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_s8(xq, sx, wq, sw, torch.from_numpy(t), out_scale=0.05,
                   impl="kernel")


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

def _trunks(num_layers, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 64, 64, 3) * 0.5).astype(np.float32)
    jm = JaxTrunk(num_layers)
    v = jax_variables(jm, jnp.asarray(x), False, seed=seed)
    port = port_from(ResNetTrunk(num_layers), v)
    return jm, v, port, x


def _port_stages(port, x):
    with torch.no_grad():
        return [o.numpy() for o in port(torch.from_numpy(x))]


@pytest.fixture(scope="module", params=[34, 18])
def trunks(request):
    return _trunks(request.param, seed=request.param)


def test_trunk_int8_matches_jax(trunks, monkeypatch):
    jm, v, port, x = trunks
    monkeypatch.setenv("COBEVT_INT8", "1")
    # eager, so that each XLA operation is the one the port mirrors
    want = jm.apply(v, jnp.asarray(x), False)
    got = _port_stages(port, x)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = np.abs(w).max()
        diff = np.abs(g - w)
        assert diff.max() <= 5e-3 * scale, (i, diff.max() / scale)
        assert (diff > 1e-4 * scale).mean() <= 1e-3, (
            i, (diff > 1e-4 * scale).mean())


def test_trunk_int8_drift_against_stock_is_bounded(trunks, monkeypatch):
    _, _, port, x = trunks
    stock = _port_stages(port, x)
    monkeypatch.setenv("COBEVT_INT8", "1")
    quant = _port_stages(port, x)
    for i, (a, b) in enumerate(zip(stock, quant)):
        rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
        assert 0 < rel < 0.1, (i, rel)


def test_trunk_saturation_fractions_equal_jax(trunks, monkeypatch):
    jm, v, port, x = trunks
    monkeypatch.setenv("COBEVT_INT8", "1")
    _, inters = jm.apply(v, jnp.asarray(x), False, mutable=["intermediates"])
    want = {k: float(np.asarray(d["int8_sat_frac"][0]))
            for k, d in inters["intermediates"].items()}
    assert port.int8_sat_fracs == []          # nothing is kept unasked
    port.collect_int8_sat = True
    try:
        _port_stages(port, x)
        got = [float(s) for s in port.int8_sat_fracs]
    finally:
        port.collect_int8_sat = False
    assert len(got) == len(want) == len(port.layer1)
    for j, s in enumerate(got):
        assert abs(s - want[f"layer1_{j}"]) <= 1e-6
    _port_stages(port, x)
    assert port.int8_sat_fracs == []


def test_trunk_flag_off_is_bitwise_stock(trunks, monkeypatch):
    _, _, port, x = trunks
    ref = _port_stages(port, x)
    monkeypatch.setenv("COBEVT_INT8", "1")
    monkeypatch.setenv("COBEVT_INT8_RESIDENT", "0")
    got = _port_stages(port, x)
    # resident lever off: layer1 and layer2 (C < 256) are the stock path
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    assert not np.array_equal(ref[2], got[2])       # K7 from layer3 on
    monkeypatch.delenv("COBEVT_INT8")
    monkeypatch.delenv("COBEVT_INT8_RESIDENT")
    for a, b in zip(ref, _port_stages(port, x)):
        np.testing.assert_array_equal(a, b)


def test_trunk_training_never_takes_the_int8_region(trunks, monkeypatch):
    _, _, port, x = trunks
    calls = []
    monkeypatch.setattr(port_chain, "conv3x3_s32",
                        lambda *a: calls.append(1))
    monkeypatch.setenv("COBEVT_INT8", "1")
    port.train()
    try:
        with torch.no_grad():
            port(torch.from_numpy(x))
    finally:
        port.eval()
    assert not calls


def test_bottleneck_trunk_is_unaffected(monkeypatch):
    """ResNet-50's layer1 carries a downsample projection: the region must
    not activate, and a bottleneck block has no fused conv."""
    torch.manual_seed(5)
    port = ResNetTrunk(50).eval()
    x = torch.randn(1, 32, 32, 3) * 0.5
    with torch.no_grad():
        ref = port(x)
        monkeypatch.setenv("COBEVT_INT8", "1")
        got = port(x)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_one_state_dict_serves_every_path(monkeypatch):
    keys = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("COBEVT_INT8", flag)
        trunk = ResNetTrunk(34).eval()
        with torch.no_grad():
            trunk(torch.zeros(1, 32, 32, 3))
        keys[flag] = {k: tuple(t.shape) for k, t in trunk.state_dict().items()}
    assert keys["0"] == keys["1"]
    assert not any("int8" in k or "_pack" in k for k in keys["1"])


def test_resident_block_rejects_a_strided_block():
    block = port_layers.BasicBlock(64, 128, stride=2, downsample=True).eval()
    with pytest.raises(ValueError, match="stride-1"):
        block.int8_resident_eval(torch.zeros(1, 4, 4, 64, dtype=torch.int8),
                                 1.0, None, torch.float32)
